"""Shared building blocks (port of ``repro/layers/common.py``), pure
functions over parameter tensors.

The reference's precision steps are kept: ``rms_norm`` and ``apply_rope``
compute in f32 and cast back; ``rope_angles`` takes its inverse frequencies
from f64 numpy, rounded to f32, and multiplies in f32; ``swiglu`` casts
silu's f32 result back to the input type before the gate product.
``shard_hint`` has no counterpart on one card, and ``softmax_xent`` waits
for the training path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, scale=None):
    """N(0, scale^2) [d_in, d_out] weights, scale 1/sqrt(d_in) by default,
    drawn in f32 from ``gen`` on its device and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    return w.to(dtype)


def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    nrm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (nrm * gamma.float()).to(dt)


@functools.lru_cache(maxsize=None)
def _inv_freq(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    inv = 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def rope_angles(positions, d_head: int, theta: float = 10000.0):
    """positions: [...]; returns (cos, sin) of shape [..., d_head//2]."""
    ang = positions[..., None].float() * _inv_freq(d_head, float(theta), positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, D]; cos/sin: [..., S, D//2] broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def swiglu(x, w1, w3, w2):
    """LLaMA-family gated MLP: (silu(x@w1) * (x@w3)) @ w2."""
    h = F.silu((x @ w1).float()).to(x.dtype) * (x @ w3)
    return h @ w2
