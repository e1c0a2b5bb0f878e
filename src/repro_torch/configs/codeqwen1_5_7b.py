"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L d_model=4096 32H (kv=32, MHA)
d_ff=13440 vocab=92416."""
import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "codeqwen1.5-7b"
FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv=32,
        d_ff=13440, vocab=92416, dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=512, dtype=torch.float32, attention_chunk=64,
    )
