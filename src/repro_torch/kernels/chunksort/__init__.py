"""Chunk-order sort: CUDA bitonic network over (key, idx) pairs + its plain version."""
from .ops import sort_with_perm  # noqa: F401
from .ref import sort_with_perm_ref  # noqa: F401
