"""Plain PyTorch versions of the capscore kernels (mirror
``repro/kernels/capscore/ref.py``).

These are what the CPU runs and what the CUDA kernel is held against; they
are not on the main path on a card.  Lanes are a leading ``[L, ...]`` batch
dimension (the reference's ``vmap``).
"""
from __future__ import annotations

import torch

from ...core import hashing as H
from ...core.samplers import SALT_ELEM, SALT_KEYBASE
from ...core.segments import is_live

_INF = float("inf")


def capscore_multi_ref(keys, eids, weights, ls, taus, salt):
    """Per-element (score, delta, entry, kb), each [L, N], for lanes
    (ls[j], taus[j]); element hashes are shared across lanes.

    ``ls``/``taus`` are f32 tensors [L] on the elements' device, so every
    division below is a tensor/tensor IEEE division (``ku / l``, not
    ``ku * (1/l)``), exactly as the reference orders them.
    """
    ls = ls.to(torch.float32)[:, None]
    taus = taus.to(torch.float32)[:, None]
    u = H.uniform01(H.hash_combine(eids, SALT_ELEM, salt))
    ku = H.uniform01(H.hash_combine(keys, SALT_KEYBASE, salt))
    e = -torch.log1p(-u)
    v = e / weights
    inv_l = 1.0 / ls
    kb = ku / ls
    score = torch.where(v <= inv_l, kb, v)
    rate = torch.maximum(inv_l, taus)
    delta = e / rate
    gate = (taus * ls > 1.0) | (kb < taus)
    entry = ((delta < weights) & gate).to(torch.int32)
    return score, delta, entry, kb


def _seg_reduce(vals, seg, C, reduce, init):
    """Per-segment reduction along the last dim (``[..., C]`` values)."""
    out = torch.full(vals.shape[:-1] + (C,), init, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(-1, seg.to(torch.int64).expand(vals.shape), vals,
                              reduce=reduce, include_self=True)


def capscore_agg_ref(ks, eids, ws, seg, ls, taus, salt):
    """Fused score + per-key segment reduce over a KEY-ORDERED chunk.

    Returns the per-unique-key ChunkAgg columns
        (w_total f32 [C], entered bool [L, C], contrib f32 [L, C],
         kb_min f32 [L, C], min_score f32 [L, C]).
    """
    C = ks.shape[0]
    score, delta, entry, kb = capscore_multi_ref(ks, eids, ws, ls, taus, salt)
    live = is_live(ks)
    idx = torch.arange(C, device=ks.device)
    w_total = _seg_reduce(torch.where(live, ws, 0.0), seg, C, "sum", 0.0)
    es = entry.bool() & live
    first_entry = _seg_reduce(torch.where(es, idx, C), seg, C, "amin", C)
    fe = first_entry.gather(-1, seg.to(torch.int64).expand(first_entry.shape))
    after = idx > fe
    at = (idx == fe) & es
    contrib_elem = torch.where(after, ws, 0.0) + torch.where(at, ws - delta, 0.0)
    contrib = _seg_reduce(torch.where(live, contrib_elem, 0.0), seg, C, "sum", 0.0)
    entered = _seg_reduce(es.to(torch.int32), seg, C, "amax", 0) > 0
    min_score = _seg_reduce(torch.where(live, score, _INF), seg, C, "amin", _INF)
    kb_min = _seg_reduce(torch.where(live, kb, _INF), seg, C, "amin", _INF)
    return w_total, entered, contrib, kb_min, min_score
