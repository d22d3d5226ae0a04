"""schnet [gnn]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10
[arXiv:1706.08566; paper].

The port of `repro.configs.schnet`, with the same values.
"""
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def model_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="schnet", d_in=16, d_hidden=64,
                     d_out=1, n_interactions=3, n_rbf=300, cutoff=10.0)


def reduced_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="schnet", d_in=8,
                     d_hidden=16, d_out=1, n_interactions=2, n_rbf=12,
                     cutoff=10.0)
