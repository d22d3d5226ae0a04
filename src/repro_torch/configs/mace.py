"""mace [gnn]: n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8
E(3)-equivariant higher-order message passing [arXiv:2206.07697; paper].

Equivariance note: features carry l ∈ {0,1,2} irreps (scalars, vectors,
traceless-symmetric rank-2); correlation order 3 is realized through the
v·T·v / |v|² / |T|² invariant contractions — see DESIGN.md for the
Clebsch–Gordan simplification relative to full e3nn MACE.

The port of `repro.configs.mace`, with the same values.
"""
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "mace"
FAMILY = "gnn"
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def model_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="mace", d_in=16, d_hidden=128,
                     d_out=1, n_layers=2, l_max=2, correlation=3,
                     mace_n_rbf=8, cutoff=10.0)


def reduced_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="mace", d_in=8,
                     d_hidden=16, d_out=1, n_layers=2, l_max=2,
                     correlation=3, mace_n_rbf=4, cutoff=10.0)
