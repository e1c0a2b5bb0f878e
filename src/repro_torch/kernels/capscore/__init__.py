"""Capped element scoring (single lane, lane grid) and the fused per-key
aggregate: CUDA kernels + plain versions."""
from .ops import capscore, capscore_agg, capscore_multi  # noqa: F401
from .ref import capscore_agg_ref, capscore_multi_ref, capscore_ref  # noqa: F401
