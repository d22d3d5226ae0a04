"""dimenet [gnn]: n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6 [arXiv:2003.03123; unverified].

The port of `repro.configs.dimenet`, with the same values.
"""
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "dimenet"
FAMILY = "gnn"
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def model_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="dimenet", d_in=16, d_hidden=128,
                     d_out=1, n_blocks=6, n_bilinear=8, n_spherical=7,
                     n_radial=6, cutoff=10.0)


def reduced_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="dimenet", d_in=8,
                     d_hidden=16, d_out=1, n_blocks=2, n_bilinear=4,
                     n_spherical=3, n_radial=4, cutoff=10.0)
