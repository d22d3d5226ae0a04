"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3
multi-interest dynamic routing [arXiv:1904.08030; unverified].

The port of `repro.configs.mind`. Item table: ~10⁷ rows × 64
(10,485,760 = 512·20480 rows)."""
from repro_torch.models.mind import MindConfig

ARCH_ID = "mind"
FAMILY = "recsys"
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def model_config() -> MindConfig:
    return MindConfig(name=ARCH_ID, n_items=10_485_760, embed_dim=64,
                      n_interests=4, capsule_iters=3, hist_len=50)


def reduced_config() -> MindConfig:
    return MindConfig(name=ARCH_ID + "-smoke", n_items=1000, embed_dim=16,
                      n_interests=4, capsule_iters=3, hist_len=10)
