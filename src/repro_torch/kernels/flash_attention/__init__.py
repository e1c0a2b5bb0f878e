"""Blockwise GQA attention: CUDA kernel + plain versions, and the backend op."""
from .ops import attention, flash_attention, xla_chunked_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401
