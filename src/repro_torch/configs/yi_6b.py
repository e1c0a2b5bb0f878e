"""yi-6b [arXiv:2403.04652]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "yi-6b"
FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv=4,
        d_ff=11008, vocab=64000, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, dtype=torch.float32, attention_chunk=64,
    )
