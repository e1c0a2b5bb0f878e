"""Chunked stream-sampler building blocks (port of ``repro/core/vectorized.py``).

The pieces on the multi-lane ingest path and the two-pass path: element
randomness and scores, the per-chunk aggregate record, the sorted-runs table
merge, the batched eviction of Algorithm 5 (§5.2), the key-sorted
bottom-(k+1) summary fold, and the pass-I bottom-k summaries and their
lossless merge (Algorithm 1).  Every function works on a stack of L lanes:
table leaves are ``[L, cap]``, per-lane scalars ``[L]`` (the reference's
``vmap`` over lanes written as a leading batch dimension).  Nothing here
synchronises with the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.capscore.ops import capscore
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
    bottom_k_by,
    chunk_order,
    compact_valid,
    is_empty,
    is_live,
    kth_smallest,
    merge_sorted_runs_gather,
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
    rounds it.  The continuous score is the ``capscore`` kernel's on a CUDA
    tensor (its plain version on the CPU): the same hashes and IEEE
    operations as the reference's inline form.
    """
    if kind == "distinct":
        s = H.uniform01(H.hash_combine(keys, salt))
    elif kind == "sh":
        s = elem_uniform(eids, salt)
    elif kind == "discrete":
        l32 = np.float32(l)
        u = H.uniform01(H.hash_combine(eids, SALT_BUCKET, salt))
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
    ukeys: torch.Tensor      # [C] unique keys (EMPTY padded), shared by lanes
    w_total: torch.Tensor    # [C] total chunk weight per key (lane-independent)
    entered: torch.Tensor    # [L, C] bool: an entry event occurred in this chunk
    contrib: torch.Tensor    # [L, C] count contribution from entry onward
    kb: torch.Tensor         # [L, C] KeyBase(x)
    min_score: torch.Tensor  # [L, C] min element score


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
    a_keys, b_keys = state.keys, agg.ukeys
    a_live = is_live(a_keys)
    b_live = is_live(b_keys)

    # table entries matched against the chunk aggregate (cached-key branch)
    loc_ab = torch.clamp(searchsorted(b_keys, a_keys), 0, C - 1)
    hit_a = (b_keys[loc_ab] == a_keys) & a_live
    counts_a = state.counts + torch.where(hit_a, agg.w_total[loc_ab], 0.0)
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
    adjustment needs.  ``tau``/``l``/``round_no`` are [L] lane columns."""
    valid = is_live(keys)
    rn = round_no[:, None]
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


def _evict_to_k(keys, counts, kb, seed, tau, k, l, salt, round_no):
    """Batched eviction: tau* = delta-th largest z with delta = n_valid - k,
    found by the rank route (``kth_smallest``); drop z >= tau* and adjust
    the survivors' counts (tau*l > 1 regime only)."""
    n = keys.shape[-1]
    valid, z, entry_thresh, ex, inv_l = _evict_z(keys, counts, kb, tau, l,
                                                 salt, round_no)
    delta = torch.clamp_min(valid.sum(-1) - k, 0)
    # delta-th largest == (n - delta)-th smallest (0-indexed)
    z_sel = kth_smallest(z, torch.clamp(n - delta, 0, n - 1))
    tau_star = torch.where(delta > 0, z_sel, tau)

    ts, pos = tau_star[:, None], (delta > 0)[:, None]
    evict = valid & (z >= ts) & pos
    new_rate = torch.maximum(inv_l, ts)
    guard = (entry_thresh >= ts) & (tau[:, None] * l[:, None] > 1.0)
    adj = counts - ex / new_rate
    counts = torch.where(valid & ~evict & guard & pos, adj, counts)
    keys_o = torch.where(evict, EMPTY, keys)
    counts_o = torch.where(evict, 0.0, counts)
    kb_o = torch.where(evict, INF, kb)
    seed_o = torch.where(evict, INF, seed)
    tau_o = torch.where(delta > 0, tau_star, tau)
    return keys_o, counts_o, kb_o, seed_o, tau_o


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

    ``skeys``/``sseeds``: [L, cap] key-sorted carry.  ``ukeys``: the chunk's
    unique keys [C] (ascending, EMPTY padded); ``mins``: [L, C] per-key min
    element scores (the fused aggregate's ``min_score`` column).
    """
    C = ukeys.shape[-1]
    cap_s = skeys.shape[-1]
    a_keys, a_live = skeys, is_live(skeys)
    b_keys, b_live = ukeys, is_live(ukeys)

    # rank passes, unclipped: the raw rank is also the count of other-run
    # keys below, which the position formulas need
    loc_ab_raw = searchsorted(b_keys, a_keys)
    loc_ba_raw = searchsorted(a_keys, b_keys)

    loc_ab = torch.clamp(loc_ab_raw, max=C - 1)
    hit_a = (b_keys[loc_ab] == a_keys) & a_live
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
    L = skeys.shape[0]
    kk = torch.full((L, cap_s + 1), EMPTY, dtype=a_keys.dtype, device=a_keys.device)
    kk.scatter_(-1, pos_a, a_keys)
    kk.scatter_(-1, pos_b, b_keys.expand(L, C))
    ss = torch.full((L, cap_s + 1), INF, dtype=sd_a.dtype, device=sd_a.device)
    ss.scatter_(-1, pos_a, sd_a)
    ss.scatter_(-1, pos_b, mins)
    return kk[:, :cap_s], ss[:, :cap_s]


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
