"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm."""
import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "qwen3-8b"
FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=36, d_model=4096, n_heads=32, n_kv=8,
        d_ff=12288, vocab=151936, qk_norm=True, d_head=128, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, qk_norm=True, dtype=torch.float32, attention_chunk=64,
    )
