"""Chunked stream-sampler building blocks (port of ``repro/core/vectorized.py``).

Element randomness and scores; the per-chunk aggregate (Algorithms 2/4
entry semantics) and its sort-inline oracle; the sorted-runs table merge
and its concatenate-and-re-sort oracle; the fixed-threshold and fixed-k
chunk steps; the batched eviction of Algorithm 5 (§5.2) and its full-sort
oracle; the key-sorted bottom-(k+1) summary fold; the pass-I bottom-k
summaries and their lossless merge (Algorithm 1); and the one-shot samplers
``sample_fixed_tau``, ``sample_fixed_k`` and ``sample_two_pass`` (the
reference's ``lax.scan`` as a Python chunk loop).  A single sketch is the
L = 1 case of the lane-stacked table.  Every function works on a stack of
rows: table leaves are ``[R, cap]``, per-row scalars ``[R]`` (the reference's
``vmap`` over lanes written as a leading batch dimension).  The rows are the
L lanes of one sampler, or the A x L (tenant, lane) rows of a multi-tenant
bank tick, where each row also has its own chunk uniques and salt.  Nothing
here synchronises with the device, apart from the one-shot samplers' host
extraction at the end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.capscore.ops import capscore, capscore_agg
from ..kernels.capscore.ref import capscore_multi_ref
from . import hashing as H
from .samplers import (
    SALT_BUCKET,
    SALT_ELEM,
    SALT_EVICT_R,
    SALT_EVICT_U,
    SALT_KEYBASE,
    SALT_SHARD,
    SampleResult,
)
from .segments import (
    EMPTY,
    ChunkOrder,
    bottom_k_by,
    chunk_order,
    compact_valid,
    is_empty,
    is_live,
    kth_smallest,
    merge_sorted_runs_gather,
    normalize_keys,
    scatter_unique,
    searchsorted,
    segment_ids,
    segment_reduce,
    sort_by_key,
)

INF = float("inf")


# ---------------------------------------------------------------------------
# Element randomness
# ---------------------------------------------------------------------------


def keybase(keys, l, salt):
    """KeyBase(x) = Hash(x)/l (``l`` a tensor broadcasting against keys)."""
    return H.uniform01(H.hash_combine(keys, SALT_KEYBASE, salt)) / l


def elem_uniform(eids, salt):
    return H.uniform01(H.hash_combine(eids, SALT_ELEM, salt))


def to_int32(x):
    """uint32 values held in int64 -> the same bit pattern as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def shard_eids(shard_no, idx):
    """Element ids for positions ``idx`` of shard/host ``shard_no``: the
    int32 bit pattern of ``hash(SALT_SHARD, shard_no, idx)``, equal to
    ``samplers.shard_eids_np`` after the uint32 cast both apply."""
    return to_int32(H.hash_combine(SALT_SHARD, shard_no, idx))


def element_scores(kind: str, keys, eids, weights, l, salt):
    """ElementScore(h) for each scheme; EMPTY-keyed elements get +inf.

    ``l`` is a host number, rounded to f32 as the reference's f32 arithmetic
    rounds it; the discrete kind also takes it as an f32 [1] tensor (a
    single sketch's lane column), with the same f32 operations.  The
    continuous score is the ``capscore`` kernel's on a CUDA tensor (its
    plain version on the CPU): the same hashes and IEEE operations as the
    reference's inline form.
    """
    if kind == "distinct":
        s = H.uniform01(H.hash_combine(keys, salt))
    elif kind == "sh":
        s = elem_uniform(eids, salt)
    elif kind == "discrete":
        u = H.uniform01(H.hash_combine(eids, SALT_BUCKET, salt))
        if isinstance(l, torch.Tensor):
            bucket = torch.minimum((u * l).to(torch.int32), (l - 1).to(torch.int32))
        else:
            l32 = np.float32(l)
            bucket = torch.clamp((u * float(l32)).to(torch.int32),
                                 max=int(l32 - np.float32(1)))
        s = H.uniform01(H.hash_combine(keys, bucket, salt))
    elif kind == "continuous":
        s = capscore(keys, eids, weights, l, INF, salt)[0]
    else:
        raise ValueError(kind)
    return torch.where(is_empty(keys), INF, s)


# ---------------------------------------------------------------------------
# Per-chunk aggregate and the sampler table
# ---------------------------------------------------------------------------


class ChunkAgg(NamedTuple):
    ukeys: torch.Tensor      # [C] unique keys (EMPTY padded), shared by lanes,
                             # or [R, C]: each row's own chunk
    w_total: torch.Tensor    # total chunk weight per key, shaped as ukeys
    entered: torch.Tensor    # [L, C] bool: an entry event occurred in this chunk
    contrib: torch.Tensor    # [L, C] count contribution from entry onward
    kb: torch.Tensor         # [L, C] KeyBase(x)
    min_score: torch.Tensor  # [L, C] min element score


# ---------------------------------------------------------------------------
# Per-chunk aggregation (Algorithms 2/4 entry semantics)
# ---------------------------------------------------------------------------
#
# Per-element columns are [R, C] rows (one per lane; R = 1 for a single
# sketch), or [C] where every row shares them (weights, a kind's scores).


def _aggregate_preordered(order: ChunkOrder, entry, at_entry_count, scores,
                          kb_elem) -> ChunkAgg:
    """Reduce a chunk per key when the per-element columns are already in
    key order (computed on ``order``'s pre-gathered view).

    ``entry`` [R, C]: the entry-event flags (live elements only);
    ``at_entry_count``: the count the entry element itself contributes
    (w - Delta for continuous, w for discrete); elements after a key's first
    entry contribute their full weight.
    """
    C = order.ks.shape[-1]
    ks, seg, ws = order.ks, order.seg, order.ws
    shape = entry.shape
    idx = torch.arange(C, device=ks.device)
    first_entry = segment_reduce(torch.where(entry, idx, C), seg, "amin", C)
    fe = first_entry.gather(-1, seg.to(torch.int64).expand(shape))
    after = idx > fe
    at = (idx == fe) & entry
    contrib_elem = torch.where(after, ws, 0.0) + torch.where(at, at_entry_count, 0.0)
    live = is_live(ks)
    contrib = segment_reduce(torch.where(live, contrib_elem, 0.0), seg, "sum", 0.0)
    w_total = segment_reduce(torch.where(live, ws, 0.0), seg, "sum", 0.0)
    entered = segment_reduce((live & entry).to(torch.int32), seg, "amax", 0) > 0
    min_score = segment_reduce(torch.where(live, scores, INF).expand(shape), seg,
                               "amin", INF)
    kb_min = segment_reduce(torch.where(live, kb_elem, INF).expand(shape), seg,
                            "amin", INF)
    return ChunkAgg(ukeys=order.ukeys, w_total=w_total, entered=entered,
                    contrib=contrib, kb=kb_min, min_score=min_score)


def _gather_along(x, perm):
    """``x`` [..., C] permuted by ``perm`` [C] along the last dim."""
    return x.gather(-1, perm.expand(x.shape))


def _aggregate_ordered(order: ChunkOrder, weights, entry, at_entry_count,
                       scores, kb_elem) -> ChunkAgg:
    """``_aggregate_preordered`` on stream-order columns: the chunk's shared
    permutation gathers them into key order first."""
    p = order.perm
    return _aggregate_preordered(
        order._replace(ws=weights[p]), _gather_along(entry, p),
        _gather_along(at_entry_count, p), _gather_along(scores, p),
        _gather_along(kb_elem, p))


def _aggregate(keys, weights, entry, at_entry_count, scores, kb_elem,
               order: ChunkOrder | None = None) -> ChunkAgg:
    """Group a chunk by key and reduce (sorts it unless ``order`` given)."""
    if order is None:
        order = chunk_order(keys)
    return _aggregate_ordered(order, weights, entry, at_entry_count, scores, kb_elem)


def _aggregate_ref(keys, weights, entry, at_entry_count, scores, kb_elem) -> ChunkAgg:
    """The aggregate with its sort inline (``torch.sort``, not the chunksort
    kernel) and the uniques by ``scatter_unique``: the oracle of the
    chunk-order aggregates, on no production path."""
    ks, perm = torch.sort(keys, stable=True)
    seg, _ = segment_ids(ks)
    ukeys = scatter_unique(ks, seg)
    order = ChunkOrder(ks=ks, perm=perm, seg=seg, ukeys=ukeys, ws=weights[perm])
    return _aggregate_preordered(
        order, _gather_along(entry, perm), _gather_along(at_entry_count, perm),
        _gather_along(scores, perm), _gather_along(kb_elem, perm))


def _with_view(order: ChunkOrder | None, keys, eids, weights) -> ChunkOrder:
    """The chunk's order with its pre-gathered eids/weights view: sorted
    here when ``order`` is omitted, gathered when it was built from the keys
    alone."""
    if order is None:
        return chunk_order(keys, eids, weights)
    if order.eids is None:
        p = order.perm
        order = order._replace(eids=eids.gather(-1, p), ws=weights.gather(-1, p))
    return order


def _continuous_entry(keys, weights, eids, tau, l, salt):
    """Per-element entry flag, at-entry count, score and KeyBase of
    Algorithm 4 under the current thresholds ``tau`` and lanes ``l`` (f32
    [R] tensors), each [R, C]: the formula of the capscore kernels' plain
    version (the reference's ``_continuous_entry``)."""
    score, delta, entry, kb = capscore_multi_ref(keys, eids, weights, l, tau, salt)
    live = is_live(keys)
    return entry.bool() & live, weights - delta, torch.where(live, score, INF), kb


def aggregate_continuous(keys, weights, eids, tau, l, salt,
                         order: ChunkOrder | None = None) -> ChunkAgg:
    """Entry semantics of Algorithm 4 under the current thresholds.

    ONE ``capscore_agg`` launch for every lane of ``l``/``tau`` (f32 [R]) on
    ``order``'s pre-gathered view (built here when omitted or missing): the
    CUDA kernel on a card, its plain version on the CPU.
    """
    order = _with_view(order, keys, eids, weights)
    w_total, entered, contrib, kb_min, min_score = capscore_agg(
        order.ks, order.eids, order.ws, order.seg, l, tau, salt)
    return ChunkAgg(ukeys=order.ukeys, w_total=w_total, entered=entered,
                    contrib=contrib, kb=kb_min, min_score=min_score)


def aggregate_continuous_ref(keys, weights, eids, tau, l, salt) -> ChunkAgg:
    """``aggregate_continuous`` through the sort-inline oracle."""
    entry, aec, scores, kb = _continuous_entry(keys, weights, eids, tau, l, salt)
    return _aggregate_ref(keys, weights, entry, aec, scores, kb)


def _discrete_entry(keys, weights, eids, tau, kind, l, salt):
    scores = element_scores(kind, keys, eids, weights, l, salt)
    return (scores < tau[:, None]) & is_live(keys), scores


def aggregate_discrete(keys, weights, eids, tau, kind, l, salt,
                       order: ChunkOrder | None = None) -> ChunkAgg:
    """Entry semantics of Algorithm 2 (``kind`` discrete, distinct or sh):
    a key enters at its first element whose score is below ``tau`` [1].
    The elements are scored in key order on ``order``'s view."""
    order = _with_view(order, keys, eids, weights)
    entry, scores = _discrete_entry(order.ks, order.ws, order.eids, tau, kind, l, salt)
    return _aggregate_preordered(order, entry, order.ws, scores, scores)


def aggregate_discrete_ref(keys, weights, eids, tau, kind, l, salt) -> ChunkAgg:
    """``aggregate_discrete`` through the sort-inline oracle."""
    entry, scores = _discrete_entry(keys, weights, eids, tau, kind, l, salt)
    return _aggregate_ref(keys, weights, entry, weights, scores, scores)


def aggregate_continuous_scored(keys, weights, score, delta, entry, kb,
                                order: ChunkOrder | None = None) -> ChunkAgg:
    """``aggregate_continuous`` on precomputed per-element scoring outputs
    [L, C] (``capscore_multi``'s)."""
    live = is_live(keys)
    return _aggregate(keys, weights, entry.bool() & live, weights - delta,
                      torch.where(live, score, INF), kb, order)


class TableState(NamedTuple):
    keys: torch.Tensor      # [L, cap] int32, ascending, unique, EMPTY last
    counts: torch.Tensor    # [L, cap] float32
    kb: torch.Tensor        # [L, cap] KeyBase payload
    seed: torch.Tensor      # [L, cap] running min element score
    tau: torch.Tensor       # [L] float32
    step: torch.Tensor      # [L] int32 (eviction round counter)
    overflow: torch.Tensor  # [L] int32


def _merge_table_sorted(state: TableState, agg: ChunkAgg):
    """Fold a chunk aggregate into the sorted table as a pairwise merge of
    two sorted runs of unique keys (no sort, no segment ops).

    cached key:  count += chunk total weight, kb/seed min with the chunk's;
    new key:     inserted iff an entry event happened, count = contrib.
    Requires the sorted-table invariant (keys ascending, unique, EMPTY
    compacted last), which the result preserves.
    """
    cap = state.keys.shape[-1]
    C = agg.ukeys.shape[-1]
    rows = state.keys.shape[:-1] + (C,)
    a_keys, b_keys = state.keys, agg.ukeys.expand(rows)
    a_live = is_live(a_keys)
    b_live = is_live(b_keys)

    # table entries matched against the chunk aggregate (cached-key branch)
    loc_ab = torch.clamp(searchsorted(b_keys, a_keys), 0, C - 1)
    hit_a = (b_keys.gather(-1, loc_ab) == a_keys) & a_live
    counts_a = state.counts + torch.where(
        hit_a, agg.w_total.expand(rows).gather(-1, loc_ab), 0.0)
    kb_a = torch.minimum(state.kb, torch.where(hit_a, agg.kb.gather(-1, loc_ab), INF))
    sd_a = torch.minimum(state.seed,
                         torch.where(hit_a, agg.min_score.gather(-1, loc_ab), INF))

    # chunk keys not in the table: inserted iff an entry event happened
    loc_ba = torch.clamp(searchsorted(a_keys, b_keys), 0, cap - 1)
    in_table = a_keys.gather(-1, loc_ba) == b_keys
    new = b_live & ~in_table & agg.entered
    newk, newcnt, newkb, newsd = compact_valid(
        new, b_keys, agg.contrib, agg.kb, agg.min_score,
        fills=(EMPTY, 0.0, INF, INF))

    # interleave the (still sorted) table run with the compacted new keys;
    # only the first ``cap`` merged positions are built
    from_b, ia, ib = merge_sorted_runs_gather(a_keys, newk, out_len=cap)

    def pick(av, bv):
        return torch.where(from_b, bv.gather(-1, ib), av.gather(-1, ia))

    n_valid = a_live.sum(-1) + new.sum(-1)
    return (pick(a_keys, newk), pick(counts_a, newcnt), pick(kb_a, newkb),
            pick(sd_a, newsd), n_valid)


def _merge_reduce(ks, st, cn, wt, en, ct, kb, sd):
    """The oracle merge's tail: segment-reduce the key-ordered union columns
    and compact the combined entries to the front.

    cached key:  count += chunk total weight (Alg 2/4/5 cached branch);
    new key:     inserted iff an entry event happened, count = contrib;
    kb, seed:    min of both.
    """
    seg, _ = segment_ids(ks)
    present = segment_reduce(st.to(torch.int32), seg, "amax", 0) > 0
    s_count = segment_reduce(cn, seg, "sum", 0.0)
    c_w = segment_reduce(wt, seg, "sum", 0.0)
    c_ent = segment_reduce(en.to(torch.int32), seg, "amax", 0) > 0
    c_ctr = segment_reduce(ct, seg, "sum", 0.0)
    kb_m = segment_reduce(kb, seg, "amin", INF)
    sd_m = segment_reduce(sd, seg, "amin", INF)
    ukeys = scatter_unique(ks, seg)
    new_count = torch.where(present, s_count + c_w, torch.where(c_ent, c_ctr, 0.0))
    valid = is_live(ukeys) & (present | c_ent)
    keys_c, counts_c, kb_c, seed_c = compact_valid(
        valid, ukeys, new_count, kb_m, sd_m, fills=(EMPTY, 0.0, INF, INF))
    return keys_c, counts_c, kb_c, seed_c, valid.sum(-1)


def _merge_table(state: TableState, agg: ChunkAgg):
    """The table merge by concatenation and a sort of all ``cap + C``
    entries: no assumption about the table's key order, the oracle of
    ``_merge_table_sorted``."""
    C = agg.ukeys.shape[-1]
    rows = state.keys.shape[:-1] + (C,)
    zeros = torch.zeros(rows, dtype=state.counts.dtype, device=state.counts.device)
    no = torch.zeros(rows, dtype=torch.bool, device=state.keys.device)
    cat = lambda a, b: torch.cat([a, b], -1)
    ks, cols = sort_by_key(
        cat(state.keys, agg.ukeys.expand(rows)), cat(is_live(state.keys), no),
        cat(state.counts, zeros), cat(torch.zeros_like(state.counts),
                                      agg.w_total.expand(rows)),
        cat(torch.zeros_like(state.keys, dtype=torch.bool), agg.entered),
        cat(torch.zeros_like(state.counts), agg.contrib), cat(state.kb, agg.kb),
        cat(state.seed, agg.min_score))
    return _merge_reduce(ks, *cols)


def fixed_k_merge(state: TableState, agg: ChunkAgg) -> TableState:
    """Fold a chunk aggregate into a fixed-k table WITHOUT evicting; the
    capacity ``k + evict_every * chunk`` guarantees the merge fits until the
    next scheduled eviction.  Increments the eviction-round counter."""
    keys_c, counts_c, kb_c, seed_c, _ = _merge_table_sorted(state, agg)
    return TableState(keys_c, counts_c, kb_c, seed_c, state.tau,
                      state.step + 1, state.overflow)


# ---------------------------------------------------------------------------
# Batched eviction (Algorithm 5, §5.2)
# ---------------------------------------------------------------------------


def _evict_z(keys, counts, kb, tau, l, salt, round_no):
    """Per-key eviction race scores z (§5.2) plus what the survivor-count
    adjustment needs.  ``tau``/``l``/``round_no`` are [R] row columns;
    ``salt`` is a sampler's int, or a bank's per-row salts [R], which hash
    as a column [R, 1] to the same bits as each row's int."""
    valid = is_live(keys)
    rn = round_no[:, None]
    if isinstance(salt, torch.Tensor):
        salt = salt[:, None]
    ux = H.uniform01(H.hash_combine(keys, SALT_EVICT_U, rn, salt))
    rx = H.uniform01(H.hash_combine(keys, SALT_EVICT_R, rn, salt))
    ex = -torch.log1p(-rx)
    tau_c, l_c = tau[:, None], l[:, None]
    inv_l = 1.0 / l_c
    safe_counts = torch.clamp_min(counts, 1e-30)
    race = torch.where(ex / safe_counts >= inv_l, ex / safe_counts, kb)
    seed_part = tau_c * ux  # tau=inf -> inf
    # score-collapse correction: the entry branch threshold becomes
    # KeyBase(x) when the resampled entry score drops below 1/l
    entry_thresh = torch.where(seed_part >= inv_l, seed_part, kb)
    z_hi = torch.minimum(entry_thresh, race)  # tau*l > 1 regime
    z = torch.where(tau_c * l_c > 1.0, z_hi, kb)  # else distinct-like
    z = torch.where(valid, z, -INF)
    return valid, z, entry_thresh, ex, inv_l


def _evict_apply(keys, counts, kb, seed, tau, l, delta, tau_star, valid, z,
                 entry_thresh, ex, inv_l):
    """Apply the eviction threshold tau* [R]: drop z >= tau*, and adjust the
    survivors' counts (tau*l > 1 regime only; see ``samplers``' notes)."""
    ts, pos = tau_star[:, None], (delta > 0)[:, None]
    evict = valid & (z >= ts) & pos
    new_rate = torch.maximum(inv_l, ts)
    guard = (entry_thresh >= ts) & (tau[:, None] * l[:, None] > 1.0)
    counts = torch.where(valid & ~evict & guard & pos, counts - ex / new_rate, counts)
    return (torch.where(evict, EMPTY, keys), torch.where(evict, 0.0, counts),
            torch.where(evict, INF, kb), torch.where(evict, INF, seed),
            torch.where(delta > 0, tau_star, tau))


def _evict_to_k(keys, counts, kb, seed, tau, k, l, salt, round_no):
    """Batched eviction: tau* = delta-th largest z with delta = n_valid - k,
    found by the rank route (``kth_smallest``); drop z >= tau* and adjust
    the survivors' counts.  The reference's ``max_evict`` / ``select``
    choose other lowerings of the same order statistic."""
    n = keys.shape[-1]
    valid, z, entry_thresh, ex, inv_l = _evict_z(keys, counts, kb, tau, l,
                                                 salt, round_no)
    delta = torch.clamp_min(valid.sum(-1) - k, 0)
    # delta-th largest == (n - delta)-th smallest (0-indexed)
    z_sel = kth_smallest(z, torch.clamp(n - delta, 0, n - 1))
    tau_star = torch.where(delta > 0, z_sel, tau)
    return _evict_apply(keys, counts, kb, seed, tau, l, delta, tau_star, valid, z,
                        entry_thresh, ex, inv_l)


def _evict_to_k_ref(keys, counts, kb, seed, tau, k, l, salt, round_no):
    """The eviction with tau* read off a full descending sort of z: the
    oracle of the rank route.  Leaves the evicted slots EMPTY in place (no
    re-compaction), as the reference's oracle does."""
    valid, z, entry_thresh, ex, inv_l = _evict_z(keys, counts, kb, tau, l,
                                                 salt, round_no)
    delta = torch.clamp_min(valid.sum(-1) - k, 0)
    z_desc = torch.sort(z, dim=-1, descending=True).values
    z_sel = z_desc.gather(-1, torch.clamp_min(delta - 1, 0)[:, None])[:, 0]
    tau_star = torch.where(delta > 0, z_sel, tau)
    return _evict_apply(keys, counts, kb, seed, tau, l, delta, tau_star, valid, z,
                        entry_thresh, ex, inv_l)


def evict_table(table: TableState, *, k, l, salt) -> TableState:
    """Evict a merged table back down to <= k valid keys per lane, then
    re-compact so the sorted-table invariant survives the EMPTY holes.  The
    round number is the table's step counter."""
    keys_e, counts_e, kb_e, seed_e, tau_e = _evict_to_k(
        table.keys, table.counts, table.kb, table.seed, table.tau, k, l, salt,
        table.step)
    keys_c, counts_c, kb_c, seed_c = compact_valid(
        is_live(keys_e), keys_e, counts_e, kb_e, seed_e,
        fills=(EMPTY, 0.0, INF, INF))
    return TableState(keys_c, counts_c, kb_c, seed_c, tau_e, table.step,
                      table.overflow)


# ---------------------------------------------------------------------------
# Single-chunk streaming steps (shared by the one-shot samplers below and by
# the incremental state API in core/incremental.py)
# ---------------------------------------------------------------------------


def init_table(capacity: int, tau=INF, *, device) -> TableState:
    """A fresh single-sketch table: the L = 1 case of the lane-stacked
    state (leaves [1, capacity], tau/step/overflow [1])."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return TableState(
        keys=torch.full((1, capacity), EMPTY, **i32),
        counts=torch.zeros((1, capacity), **f32),
        kb=torch.full((1, capacity), INF, **f32),
        seed=torch.full((1, capacity), INF, **f32),
        tau=torch.full((1,), float(tau), **f32),
        step=torch.zeros((1,), **i32),
        overflow=torch.zeros((1,), **i32))


def fixed_tau_step(state: TableState, keys, weights, eids, l, salt, *, kind,
                   order: ChunkOrder | None = None) -> TableState:
    """Advance a fixed-threshold sampler (Alg 2/4) by one chunk; merged keys
    past the capacity are counted in ``overflow``."""
    capacity = state.keys.shape[-1]
    if kind == "continuous":
        agg = aggregate_continuous(keys, weights, eids, state.tau, l, salt, order)
    else:
        agg = aggregate_discrete(keys, weights, eids, state.tau, kind, l, salt, order)
    keys_c, counts_c, kb_c, seed_c, n_valid = _merge_table_sorted(state, agg)
    over = state.overflow + torch.clamp_min(n_valid - capacity, 0).to(torch.int32)
    return TableState(keys_c, counts_c, kb_c, seed_c, state.tau, state.step + 1, over)


def fixed_k_step(state: TableState, keys, weights, eids, l, salt, *, k,
                 order: ChunkOrder | None = None) -> TableState:
    """Advance a fixed-k continuous sampler (Alg 5) by one chunk: aggregate
    under the current threshold (one ``capscore_agg`` launch), merge,
    batch-evict back down to <= k.  The incoming table holds <= k keys."""
    agg = aggregate_continuous(keys, weights, eids, state.tau, l, salt, order)
    return evict_table(fixed_k_merge(state, agg), k=k, l=l, salt=salt)


def fixed_k_step_scored(state: TableState, keys, weights, score, delta, entry, kb,
                        *, k, l, salt, order: ChunkOrder | None = None) -> TableState:
    """``fixed_k_step`` on precomputed ``capscore_multi`` outputs [L, C]."""
    agg = aggregate_continuous_scored(keys, weights, score, delta, entry, kb, order)
    return evict_table(fixed_k_merge(state, agg), k=k, l=l, salt=salt)


def fixed_k_step_scored_ref(state: TableState, keys, weights, score, delta,
                            entry, kb, *, k, l, salt) -> TableState:
    """The chunk step through the oracles: the sort-inline aggregate, the
    concatenate-and-re-sort merge and the full-sort eviction (whose EMPTY
    holes stay in place; the next merge re-sorts them last)."""
    capacity = state.keys.shape[-1]
    live = is_live(keys)
    agg = _aggregate_ref(keys, weights, entry.bool() & live, weights - delta,
                         torch.where(live, score, INF), kb)
    keys_c, counts_c, kb_c, seed_c, _ = _merge_table(state, agg)
    step = state.step + 1
    keys_e, counts_e, kb_e, seed_e, tau_e = _evict_to_k_ref(
        keys_c[:, :capacity], counts_c[:, :capacity], kb_c[:, :capacity],
        seed_c[:, :capacity], state.tau, k, l, salt, step)
    return TableState(keys_e, counts_e, kb_e, seed_e, tau_e, step, state.overflow)


# ---------------------------------------------------------------------------
# Pass-I bottom-k summaries (Algorithm 1) and their lossless merge
# ---------------------------------------------------------------------------


def chunk_bottomk_summary(keys, eids, weights, l, salt, *, kind):
    """Per-chunk (unique key, min element score) summary for pass-1 bottom-k."""
    scores = element_scores(kind, keys, eids, weights, l, salt)
    ks, (sc,) = sort_by_key(keys, scores)
    seg, _ = segment_ids(ks)
    mins = segment_reduce(torch.where(is_live(ks), sc, INF), seg, "amin", INF)
    ukeys = scatter_unique(ks, seg)
    return ukeys, torch.where(is_live(ukeys), mins, INF)


def merge_bottomk_summary(skeys, sseeds, ukeys, useeds, cap):
    """Merge two (key, seed) summaries: min-seed per duplicate key,
    bottom-cap, along the last dim.  Lossless for the bottom-cap of the
    union (paper §3.1).  ``ukeys`` may be one [C] row shared by every lane
    of ``skeys`` [L, cap] (a chunk's unique keys)."""
    ukeys = ukeys.expand(skeys.shape[:-1] + ukeys.shape[-1:])
    keys2 = torch.cat([skeys, ukeys], -1)
    seeds2 = torch.cat([sseeds, useeds], -1)
    ks2, (sd2,) = sort_by_key(keys2, seeds2)
    seg2, _ = segment_ids(ks2)
    sd_m = segment_reduce(sd2, seg2, "amin", INF)
    uk2 = scatter_unique(ks2, seg2)
    sd_m = torch.where(is_live(uk2), sd_m, INF)
    sd_k, uk_k = bottom_k_by(sd_m, cap, uk2, fills=(EMPTY,))
    return uk_k, sd_k


def pass1_step(carry, keys, weights, eids, l, salt, *, kind, cap):
    """Advance a bottom-k-by-seed summary (Alg 1 pass I) by one chunk."""
    skeys, sseeds = carry
    ukeys, mins = chunk_bottomk_summary(keys, eids, weights, l, salt, kind=kind)
    return merge_bottomk_summary(skeys, sseeds, ukeys, mins, cap)


def chunk_bottomk_summary_scored(keys, scores):
    """Per-lane (unique key, min element score) chunk summaries from
    precomputed multi-lane scores [L, C] (the ``capscore_multi`` path).

    One sort of the chunk by key (``chunk_order``: the chunksort kernel on a
    card) is shared by all lanes.  Returns (ukeys [C], mins [L, C]).
    """
    order = chunk_order(keys)
    live = is_live(order.ks)
    mins = segment_reduce(torch.where(live, scores[:, order.perm], INF),
                          order.seg, "amin", INF)
    return order.ukeys, torch.where(is_live(order.ukeys), mins, INF)


def pass1_step_scored(carry, keys, scores, *, cap):
    """Advance a single-lane bottom-cap summary ([cap] keys/seeds) by one
    chunk whose element scores [C] were already computed (``element_scores``
    over a batch of chunks): ``pass1_step`` without the scoring."""
    skeys, sseeds = carry
    ukeys, mins = chunk_bottomk_summary_scored(keys, scores[None])
    return merge_bottomk_summary(skeys, sseeds, ukeys, mins[0], cap)


def pass1_step_multi(carry, keys, scores, *, cap):
    """Advance stacked per-lane bottom-cap summaries ([L, cap] keys/seeds)
    by one chunk whose multi-lane scores were already computed
    (``capscore_multi``)."""
    skeys, sseeds = carry
    ukeys, mins = chunk_bottomk_summary_scored(keys, scores)
    return merge_bottomk_summary(skeys, sseeds, ukeys, mins, cap)


# ---------------------------------------------------------------------------
# Key-sorted bottom-(k+1) summary carry
# ---------------------------------------------------------------------------
#
# Between batches the per-lane bottom-cap summaries are stored seed-sorted
# (the state/checkpoint layout); within a batch they are carried KEY-sorted
# (ascending, unique, EMPTY last), which turns each chunk's advance into
# rank passes, prefix sums and scatters.  Bottom-k sketches compose exactly
# (paper §3.1), and ties at the truncation threshold keep the smallest keys
# first — what the seed-sorted selection keeps too — so the layout changes
# no bit of the result.


def summary_to_keysorted(skeys, sseeds):
    """Seed-sorted summary -> key-sorted carry (per lane)."""
    o = torch.sort(skeys, dim=-1, stable=True).indices
    return skeys.gather(-1, o), sseeds.gather(-1, o)


def summary_from_keysorted(skeys, sseeds, cap):
    """Key-sorted carry -> seed-ascending state layout via the bottom-k
    selection (ties: lowest index, i.e. smallest key, first)."""
    sd_k, uk_k = bottom_k_by(sseeds, cap, skeys, fills=(EMPTY,))
    return uk_k, sd_k


def _rank_before(cs, loc_raw):
    """cs[loc_raw - 1] where loc_raw > 0, else 0 (cross-run prefix counts)."""
    return torch.where(loc_raw > 0, cs.gather(-1, torch.clamp_min(loc_raw - 1, 0)), 0)


def pass1_fold_keysorted(skeys, sseeds, ukeys, mins, cap):
    """One chunk of bottom-cap summary advance on the key-sorted carry.

    ``skeys``/``sseeds``: [R, cap] key-sorted carry.  ``ukeys``: the chunk's
    unique keys [C] (ascending, EMPTY padded), or [R, C] per row; ``mins``:
    [R, C] per-key min element scores (the fused aggregate's ``min_score``
    column).
    """
    C = ukeys.shape[-1]
    cap_s = skeys.shape[-1]
    L = skeys.shape[0]
    a_keys, a_live = skeys, is_live(skeys)
    b_keys = ukeys.expand(L, C)
    b_live = is_live(b_keys)

    # rank passes, unclipped: the raw rank is also the count of other-run
    # keys below, which the position formulas need
    loc_ab_raw = searchsorted(b_keys, a_keys)
    loc_ba_raw = searchsorted(a_keys, b_keys)

    loc_ab = torch.clamp(loc_ab_raw, max=C - 1)
    hit_a = (b_keys.gather(-1, loc_ab) == a_keys) & a_live
    sd_a = torch.minimum(sseeds, torch.where(hit_a, mins.gather(-1, loc_ab), INF))

    loc_ba = torch.clamp(loc_ba_raw, max=cap_s - 1)
    new = b_live & ~(a_keys.gather(-1, loc_ba) == b_keys)

    # bottom-cap threshold: cap-th smallest seed of the union, by rank
    sd_a_live = torch.where(a_live, sd_a, INF)
    sd_b_new = torch.where(new, mins, INF)
    thr = kth_smallest(torch.cat([sd_a_live, sd_b_new], -1), cap - 1)[:, None]

    # seeds strictly below thr survive; the remaining quota goes to
    # thr-tied entries smallest-key-first
    below_a = a_live & (sd_a < thr)
    below_b = new & (mins < thr)
    tied_a = a_live & (sd_a == thr)
    tied_b = new & (mins == thr)
    quota = (cap - (below_a.sum(-1) + below_b.sum(-1)))[:, None]
    cst_a = torch.cumsum(tied_a, -1)
    cst_b = torch.cumsum(tied_b, -1)
    keep_a = below_a | (tied_a & (cst_a - 1 + _rank_before(cst_b, loc_ab_raw) < quota))
    keep_b = below_b | (tied_b & (cst_b - 1 + _rank_before(cst_a, loc_ba_raw) < quota))

    # merged position = kept same-run entries before it + kept other-run
    # keys below it; dropped entries land on the sacrificial slot cap_s
    csa = torch.cumsum(keep_a, -1)
    csb = torch.cumsum(keep_b, -1)
    pos_a = torch.clamp(torch.where(keep_a, csa - 1 + _rank_before(csb, loc_ab_raw),
                                    cap_s), max=cap_s)
    pos_b = torch.clamp(torch.where(keep_b, csb - 1 + _rank_before(csa, loc_ba_raw),
                                    cap_s), max=cap_s)
    kk = torch.full((L, cap_s + 1), EMPTY, dtype=a_keys.dtype, device=a_keys.device)
    kk.scatter_(-1, pos_a, a_keys)
    kk.scatter_(-1, pos_b, b_keys)
    ss = torch.full((L, cap_s + 1), INF, dtype=sd_a.dtype, device=sd_a.device)
    ss.scatter_(-1, pos_a, sd_a)
    ss.scatter_(-1, pos_b, mins)
    return kk[:, :cap_s], ss[:, :cap_s]


# ---------------------------------------------------------------------------
# One-shot samplers: fixed threshold (Alg 2/4), fixed k (Alg 5), two-pass
# (Alg 1).  ``device=None`` is the CUDA card (and raises without one).
# ---------------------------------------------------------------------------


def _prep(keys, weights, chunk, device):
    """Validated int32 keys and f32 weights (unit where ``None``), padded to
    whole chunks with EMPTY / 0 (the end-of-stream padding), on ``device``."""
    keys = normalize_keys(keys)
    n = len(keys)
    weights = (np.ones(n, np.float32) if weights is None
               else np.asarray(weights, np.float32).reshape(-1))
    pad = (-n) % chunk
    if pad:
        keys = np.concatenate([keys, np.full(pad, EMPTY, np.int32)])
        weights = np.concatenate([weights, np.zeros(pad, np.float32)])
    return torch.from_numpy(keys).to(device), torch.from_numpy(weights).to(device)


def _setup(keys, weights, chunk, device, l):
    """The device, the prepared stream, its int32 element ids (stream
    positions) and the lane column ``l`` as f32 [1]."""
    from .incremental import resolve_device  # deferred: incremental imports this module

    device = resolve_device(device)
    ks, ws = _prep(keys, weights, chunk, device)
    eids = torch.arange(ks.shape[0], dtype=torch.int32, device=device)
    return ks, ws, eids, torch.tensor([l], dtype=torch.float32, device=device)


def sample_fixed_tau(keys, weights=None, *, tau, l, kind="continuous", salt=0,
                     chunk=2048, capacity=8192, device=None) -> SampleResult:
    """Fixed-threshold sample (Algorithm 4 for ``kind="continuous"``,
    Algorithm 2 for discrete, distinct and sh), element-exact.  Raises when
    the sample outgrows ``capacity``."""
    ks, ws, eids, l_t = _setup(keys, weights, chunk, device, l)
    st = init_table(capacity, tau, device=ks.device)
    for lo in range(0, ks.shape[0], chunk):
        hi = lo + chunk
        st = fixed_tau_step(st, ks[lo:hi], ws[lo:hi], eids[lo:hi], l_t, salt, kind=kind)
    overflow = int(st.overflow[0])
    if overflow > 0:
        raise RuntimeError(f"fixed-tau capacity overflow ({overflow}); raise capacity")
    return table_result(st, l=l, kind=kind, tau=float(tau))


def sample_fixed_k(keys, weights=None, *, k, l, salt=0, chunk=2048,
                   device=None) -> SampleResult:
    """1-pass fixed-size continuous SH_l sample (Algorithm 5 with batched
    evictions, the paper's recommended scheme)."""
    ks, ws, eids, l_t = _setup(keys, weights, chunk, device, l)
    st = init_table(k + chunk, device=ks.device)  # <= k valid + <= chunk new
    for lo in range(0, ks.shape[0], chunk):
        hi = lo + chunk
        st = fixed_k_step(st, ks[lo:hi], ws[lo:hi], eids[lo:hi], l_t, salt, k=k)
    return table_result(st, l=l, kind="continuous", tau=float(st.tau[0]))


def sample_two_pass(keys, weights=None, *, k, l, kind="continuous", salt=0,
                    chunk=2048, device=None) -> SampleResult:
    """Algorithm 1: pass I the exact bottom-(k+1) keys by seed, scored in
    batches of ``distributed.SCORE_BATCH`` elements (the ``capscore``
    kernel for continuous on a card); pass II the exact weights of the k
    sampled keys (f64 sums: exact for integer weights on any device)."""
    from . import distributed as DZ  # deferred: distributed imports this module

    ks, ws, eids, _ = _setup(keys, weights, chunk, device, l)
    skeys, sseeds = DZ.pass1_scored(ks, ws, eids, kind=kind, l=l, salt=salt,
                                    cap=k + 1, chunk=chunk)
    skeys, sseeds = skeys.cpu().numpy(), sseeds.cpu().numpy()
    valid = is_live(skeys)
    order = np.argsort(sseeds[valid])
    kk = skeys[valid][order]
    if len(kk) > k:
        tau = float(sseeds[valid][order][k])
        kk = kk[:k]
    else:
        tau = float("inf")
    sampled = np.sort(kk)
    counts = np.zeros(0)
    if len(sampled):
        sd = torch.from_numpy(sampled).to(ks.device)
        loc = torch.clamp(searchsorted(sd, ks), 0, len(sampled) - 1)
        match = (sd[loc] == ks) & is_live(ks)
        acc = torch.zeros(len(sampled), dtype=torch.float64, device=ks.device)
        counts = acc.scatter_add_(0, loc, torch.where(match, ws.double(), 0.0)).cpu().numpy()
    return SampleResult(keys=sampled, counts=counts, tau=tau, l=l, kind=kind,
                        exact_weights=True)


# ---------------------------------------------------------------------------
# Host extraction
# ---------------------------------------------------------------------------


def _to_result(keys: np.ndarray, counts: np.ndarray, *, l, kind, tau) -> SampleResult:
    """One lane's host arrays -> SampleResult (valid keys, ascending)."""
    counts = np.asarray(counts, dtype=np.float64)
    valid = is_live(keys)
    order = np.argsort(keys[valid])
    return SampleResult(
        keys=keys[valid][order], counts=counts[valid][order], tau=tau, l=l,
        kind=kind,
    )


def table_result(st: TableState, *, l, kind, tau) -> SampleResult:
    """A single-sketch table ([1, cap] leaves) -> SampleResult."""
    return _to_result(st.keys[0].cpu().numpy(), st.counts[0].cpu().numpy(),
                      l=l, kind=kind, tau=tau)
