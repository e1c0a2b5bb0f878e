"""The plain PyTorch version of the attention kernel (mirrors
``repro/kernels/flash_attention/ref.py``).

``attention_ref`` is the naive oracle: it materialises the S x S scores in
f32, takes any S, and is what ``flash_attention`` runs for a CPU tensor.
q, k, v are [B, H, S, D].
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """Naive GQA attention with an f32 softmax; returns q.dtype."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float())
    s = s / (D**0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)
