"""graphcast [gnn]: n_layers=16 d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 — encoder-processor-decoder mesh GNN
[arXiv:2212.12794; unverified].

The multi-refinement icosahedral mesh is abstracted as a grid→mesh
assignment with a 16:1 coarsening ratio (refinement-6 proxy); mesh
topology arrives as precomputed input arrays. Output head predicts the
227 surface/atmo variables per grid node.

The port of `repro.configs.graphcast`, with the same values.
"""
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "graphcast"
FAMILY = "gnn"
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def model_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID, arch="graphcast", d_in=227, d_hidden=512,
                     d_out=227, n_process_layers=16, mesh_ratio=16)


def reduced_config() -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-smoke", arch="graphcast", d_in=8,
                     d_hidden=32, d_out=8, n_process_layers=2, mesh_ratio=8)
