"""Counter-based stateless hashing: the randomness substrate of every sampler.

Port of ``repro/core/hashing.py``.  The score of an element is a pure
function of ``(salt, key, element_id)`` and per-key randomness of
``(salt, key)``, so the port reproduces the reference's samples from the same
inputs with no generator state.

PyTorch has no shifts or adds for ``torch.uint32`` on every device, so the
torch variants carry each uint32 value in an ``int64`` lane, always masked to
``[0, 2**32)``.  Products are split into 16-bit halves so that no
intermediate leaves the int64 range.  The numpy twins (host oracle) are bit
for bit the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

_C1 = 0x7FEB352D
_C2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SEED0 = 0x243F6A88  # pi fractional bits
_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# numpy variants (host / oracle)
# ---------------------------------------------------------------------------


def mix32_np(x: np.ndarray) -> np.ndarray:
    """Avalanche-mix a uint32 array (splitmix32 finalizer)."""
    x = np.array(x, dtype=np.uint32, copy=True)  # never mutate the caller
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(_C1)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(_C2)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def hash_combine_np(*parts) -> np.ndarray:
    """Hash a tuple of int arrays into uint32 (order-sensitive)."""
    h = np.uint32(_SEED0)
    for p in parts:
        p32 = np.asarray(p).astype(np.uint32)
        h = mix32_np(h ^ (p32 + np.uint32(_GOLDEN) + (h << np.uint32(6))
                          + (h >> np.uint32(2))))
    return h


def uniform01_np(h: np.ndarray) -> np.ndarray:
    """uint32 -> float64 in (0, 1): (h + 0.5) / 2^32."""
    return (np.asarray(h, dtype=np.uint64).astype(np.float64) + 0.5) / 4294967296.0


# ---------------------------------------------------------------------------
# torch variants (device) — int64 lanes holding uint32 values
# ---------------------------------------------------------------------------


def as_u32(x, device=None):
    """An integer as its uint32 bit pattern (two's complement wrap, like
    ``astype(uint32)``): tensors become int64 tensors, Python ints and numpy
    scalars stay Python ints, other arrays become int64 tensors on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    if isinstance(x, (int, np.integer)):
        return int(x) & _M32
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device) & _M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32): 16-bit halves keep every
    intermediate below 2^49."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """Avalanche-mix uint32 values held in int64 lanes (or a Python int)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def hash_combine(*parts, device=None):
    """Order-sensitive hash of integer parts into uint32 values in int64.

    Tensor parts broadcast; Python-int parts stay on the host, so hashing a
    device tensor with constant salts creates no device tensor from a host
    scalar.  Array-like parts become tensors on ``device``.
    """
    h = _SEED0
    for p in parts:
        p32 = as_u32(p, device)
        h = mix32(h ^ ((p32 + _GOLDEN + ((h << 6) & _M32) + (h >> 2)) & _M32))
    return h


def uniform01(h: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in (0,1) from the top 24 bits (exact in f32)."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)

