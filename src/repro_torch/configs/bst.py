"""bst [arXiv:1905.06874]: embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq."""
import torch

from ..models.recsys import BSTConfig

ARCH_ID = "bst"
FAMILY = "recsys"


def full_config() -> BSTConfig:
    return BSTConfig(name=ARCH_ID, n_items=10_000_000, embed_dim=32, seq_len=20,
                     n_heads=8, n_blocks=1, mlp=(1024, 512, 256), dtype=torch.float32)


def smoke_config() -> BSTConfig:
    return BSTConfig(name=ARCH_ID + "-smoke", n_items=1000, embed_dim=16, seq_len=8,
                     n_heads=2, n_blocks=1, d_ff=32, mlp=(64, 32, 16), dtype=torch.float32)
