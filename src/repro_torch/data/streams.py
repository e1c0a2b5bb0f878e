"""Synthetic key streams (port of ``repro/data/streams.py``'s generator).

Numpy only: the same seed gives the same arrays as the reference.
"""
from __future__ import annotations

import numpy as np


def zipf_keys(rng: np.random.Generator, n: int, alpha: float, n_keys: int) -> np.ndarray:
    """Zipf(alpha) keys truncated to [0, n_keys) — the paper's §7 generator."""
    z = rng.zipf(alpha, size=n)
    return (z % n_keys).astype(np.int64)
