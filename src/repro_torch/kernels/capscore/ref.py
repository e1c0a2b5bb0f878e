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
from ...core.segments import is_live, segment_reduce

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


def capscore_ref(keys, eids, weights, l, tau, salt):
    """Single-lane (score, delta, entry), each [N], under scalar (l, tau):
    lane 0 of ``capscore_multi_ref`` with ``l``/``tau`` rounded to f32 (the
    reference's ``jnp.float32(l)``).  They become f32 tensors on the
    elements' device, so the divisions stay tensor/tensor (PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal)."""
    lt = torch.tensor([l, tau], dtype=torch.float32, device=keys.device)
    score, delta, entry, _ = capscore_multi_ref(keys, eids, weights, lt[:1],
                                                lt[1:], salt)
    return score[0], delta[0], entry[0]


def capscore_agg_ref(ks, eids, ws, seg, ls, taus, salt):
    """Fused score + per-key segment reduce over a KEY-ORDERED chunk.

    Returns the per-unique-key ChunkAgg columns
        (w_total f32 [C], entered bool [L, C], contrib f32 [L, C],
         kb_min f32 [L, C], min_score f32 [L, C]).

    A batch of chunks (``ks``, ``eids``, ``ws``, ``seg`` [B, C], ``taus``
    [B, L], ``salt`` a tensor of B salts) is reduced row by row, each row
    exactly as the single chunk, and the columns stacked on a leading [B].
    """
    if ks.dim() == 2:
        salts = [int(s) & 0xFFFFFFFF for s in salt.to(torch.int64).tolist()]
        rows = [capscore_agg_ref(ks[b], eids[b], ws[b], seg[b], ls, taus[b], salts[b])
                for b in range(ks.shape[0])]
        return tuple(torch.stack(cols) for cols in zip(*rows))
    C = ks.shape[0]
    score, delta, entry, kb = capscore_multi_ref(ks, eids, ws, ls, taus, salt)
    live = is_live(ks)
    idx = torch.arange(C, device=ks.device)
    w_total = segment_reduce(torch.where(live, ws, 0.0), seg, "sum", 0.0)
    es = entry.bool() & live
    first_entry = segment_reduce(torch.where(es, idx, C), seg, "amin", C)
    fe = first_entry.gather(-1, seg.to(torch.int64).expand(first_entry.shape))
    after = idx > fe
    at = (idx == fe) & es
    contrib_elem = torch.where(after, ws, 0.0) + torch.where(at, ws - delta, 0.0)
    contrib = segment_reduce(torch.where(live, contrib_elem, 0.0), seg, "sum", 0.0)
    entered = segment_reduce(es.to(torch.int32), seg, "amax", 0) > 0
    min_score = segment_reduce(torch.where(live, score, _INF), seg, "amin", _INF)
    kb_min = segment_reduce(torch.where(live, kb, _INF), seg, "amin", _INF)
    return w_total, entered, contrib, kb_min, min_score
