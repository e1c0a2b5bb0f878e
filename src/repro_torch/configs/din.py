"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn."""
import torch

from ..models.recsys import DINConfig

ARCH_ID = "din"
FAMILY = "recsys"


def full_config() -> DINConfig:
    return DINConfig(name=ARCH_ID, n_items=10_000_000, embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80), dtype=torch.float32)


def smoke_config() -> DINConfig:
    return DINConfig(name=ARCH_ID + "-smoke", n_items=1000, embed_dim=8, seq_len=16,
                     attn_mlp=(16, 8), mlp=(32, 16), dtype=torch.float32)
