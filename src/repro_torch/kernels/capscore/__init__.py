"""Fused multi-lane scoring + per-key aggregation: CUDA kernel + plain version."""
from .ops import capscore_agg  # noqa: F401
from .ref import capscore_agg_ref, capscore_multi_ref  # noqa: F401
