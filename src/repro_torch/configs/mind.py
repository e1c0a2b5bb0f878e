"""mind [arXiv:1904.08030]: embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest."""
import torch

from ..models.recsys import MINDConfig

ARCH_ID = "mind"
FAMILY = "recsys"


def full_config() -> MINDConfig:
    return MINDConfig(name=ARCH_ID, n_items=10_000_000, embed_dim=64, seq_len=50,
                      n_interests=4, capsule_iters=3, dtype=torch.float32)


def smoke_config() -> MINDConfig:
    return MINDConfig(name=ARCH_ID + "-smoke", n_items=1000, embed_dim=16,
                      seq_len=12, n_interests=2, capsule_iters=2, dtype=torch.float32)
