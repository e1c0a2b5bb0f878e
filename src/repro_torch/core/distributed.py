"""Distributed stream sampling (port of ``repro/core/distributed.py``): the
paper's two passes for distributed data (§2, §3.1) on ``torch.distributed``.

Bottom-k summaries of two streams merge losslessly into the bottom-k
summary of the union.  Every rank of a process group runs pass I over its
stream shard with shard-hashed element ids (``vectorized.shard_eids`` of the
rank), so randomness never aliases across shards; the summaries then merge
across ranks:

* all-gather merge: one hop, O(P * k) state per rank — right for small k,
  and for group sizes that are not a power of two;
* butterfly merge: log2(P) pair exchanges (``batch_isend_irecv`` with peer
  ``rank ^ stage``) of O(k) state, each followed by a local bottom-k merge;
  other group sizes fall back to the all-gather merge (same result);

and pass II (exact weights of the sampled keys) is a per-rank scatter-add
followed by an ``all_reduce`` — the paper's two-pass distributed scheme.
``make_distributed_two_pass_multi`` runs the whole l-grid in one program:
the ``capscore_multi`` kernel scores each element once, in launches of up
to 2^20 elements, and every lane reuses the element hashes.

Transport: NCCL refuses two ranks on one GPU, so the collectives also run
on a gloo group, which moves the [L, k+1] summaries and weights through
host memory; on an NCCL group they stay on the card.  The choice reads the
group's backend only.  All pass-I and pass-II compute stays on the
program's device either way.

Two cross-host merge families, as in the reference:

* ``merge_bottomk`` / ``merge_bottomk_multi`` — lossless summary merges,
  exact for any element split (the service's exact mode);
* ``merge_fixed_k`` / ``merge_fixed_k_multi`` — 1-pass sketch merges,
  unbiased for key-partitioned shards, ~10% bias for element splits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.capscore.ops import capscore_multi
from . import vectorized as VZ
from .incremental import resolve_device
from .segments import (
    EMPTY,
    compact_valid,
    is_live,
    normalize_keys,
    scatter_unique,
    searchsorted,
    segment_ids,
    segment_reduce,
    sort_by_key,
)

INF = float("inf")
MERGES = ("tree", "allgather")


# ---------------------------------------------------------------------------
# Mergeable bottom-k summaries
# ---------------------------------------------------------------------------


def merge_bottomk(keys_a, seeds_a, keys_b, seeds_b, k: int):
    """Merge two bottom-k (key, seed) summaries: min-seed per key, bottom-k
    along the last dim.  Lossless for bottom-k of the union (paper §3.1)."""
    return VZ.merge_bottomk_summary(keys_a, seeds_a, keys_b, seeds_b, k)


def merge_bottomk_multi(keys_a, seeds_a, keys_b, seeds_b, *, cap):
    """Lane-wise lossless min-merge of stacked bottom-cap summaries [L, cap]
    — the exact-mode multi-host path of ``stats.service``."""
    return merge_bottomk(keys_a, seeds_a, keys_b, seeds_b, cap)


def merge_bottomk_multi_states(summaries, *, cap):
    """Fold stacked per-lane bottom-cap summaries ``[(keys, seeds), ...]``
    into one pair.  Min-merge is associative and commutative, so the fold
    shape cannot change a bit of the result."""
    summaries = list(summaries)
    if not summaries:
        raise ValueError("no summaries to merge")
    ka, sa = summaries[0]
    for kb, sb in summaries[1:]:
        ka, sa = merge_bottomk_multi(ka, sa, kb, sb, cap=cap)
    return ka, sa


# ---------------------------------------------------------------------------
# Collectives over a process group
# ---------------------------------------------------------------------------


def transport_device(group, device) -> torch.device:
    """Where a collective's buffers live: on ``device`` for an NCCL group,
    in host memory for gloo (and any other backend)."""
    return device if "nccl" in str(dist.get_backend(group)) else torch.device("cpu")


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _pack(keys, seeds):
    """One int32 buffer [2, ...] of keys and the seeds' bit patterns."""
    return torch.stack([keys, seeds.contiguous().view(torch.int32)])


def _unpack(packed):
    return packed[0], packed[1].contiguous().view(torch.float32)


def _exchange(packed, peer: int, group):
    """Send ``packed`` to ``peer`` and receive the peer's in one batch."""
    send = packed.to(transport_device(group, packed.device))
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer, group),
                                       dist.P2POp(dist.irecv, recv, peer, group)]):
        req.wait()
    return recv.to(packed.device)


def _all_gather(packed, group) -> list[torch.Tensor]:
    send = packed.to(transport_device(group, packed.device))
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return [p.to(packed.device) for p in parts]


def all_reduce_sum(t, group=None):
    """The pass-II ``psum``: the elementwise sum of ``t`` over the group."""
    buf = t.to(transport_device(group, t.device), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def tree_merge_bottomk_multi(keys, seeds, cap: int, group=None):
    """Butterfly merge of stacked per-lane summaries ([L, cap] per rank):
    each hop exchanges the whole stack once with peer ``rank ^ stage``, then
    merges lane-wise locally.  log2(P) hops of O(L * cap) bytes.  A group
    size that is not a power of two falls back to the all-gather merge."""
    size = dist.get_world_size(group)
    if size & (size - 1):
        return allgather_merge_bottomk_multi(keys, seeds, cap, group)
    rank = dist.get_rank(group)
    stage = 1
    while stage < size:
        other = _exchange(_pack(keys, seeds), _global_rank(group, rank ^ stage), group)
        keys, seeds = merge_bottomk(keys, seeds, *_unpack(other), cap)
        stage *= 2
    return keys, seeds


def allgather_merge_bottomk_multi(keys, seeds, cap: int, group=None):
    """One-hop merge of stacked per-lane summaries [L, cap]: all-gather,
    then one local bottom-cap merge per lane."""
    L = keys.shape[0]
    parts = [_unpack(p) for p in _all_gather(_pack(keys, seeds), group)]
    all_keys = torch.cat([k for k, _ in parts], -1)
    all_seeds = torch.cat([s for _, s in parts], -1)
    empty_k = torch.full((L, 1), EMPTY, dtype=keys.dtype, device=keys.device)
    empty_s = torch.full((L, 1), INF, dtype=seeds.dtype, device=seeds.device)
    return merge_bottomk(all_keys, all_seeds, empty_k, empty_s, cap)


def tree_merge_bottomk(keys, seeds, k: int, group=None):
    """Butterfly bottom-k merge of one [k] summary per rank."""
    mk, ms = tree_merge_bottomk_multi(keys[None], seeds[None], k, group)
    return mk[0], ms[0]


def allgather_merge_bottomk(keys, seeds, k: int, group=None):
    """One-hop bottom-k merge of one [k] summary per rank."""
    mk, ms = allgather_merge_bottomk_multi(keys[None], seeds[None], k, group)
    return mk[0], ms[0]


# ---------------------------------------------------------------------------
# Mergeable fixed-k continuous states (1-pass sketches across hosts)
# ---------------------------------------------------------------------------


def merge_fixed_k_multi(table_a, table_b, ls, salt, *, k):
    """Lane-wise merge of two stacked multi-l fixed-k states ([L, cap]
    leaves, ``ls`` f32 [L] on their device) under a shared threshold.

    Union the tables; combine duplicate keys (counts add, KeyBase and seed
    min, plus one expected entry clip ``1/max(1/l, tau)`` per extra host — a
    key that entered on m hosts paid m entry-time clips while the
    continuous estimator corrects for exactly one); adopt the lower
    threshold; run one batched eviction round back down to <= k keys.  The
    result keeps ``table_a``'s capacity, so it can ingest or merge again.
    Unbiased for key-partitioned shards; for element splits the 1-pass
    merge is approximate (use the two-pass path for exactness).
    """
    cap = table_a.keys.shape[-1]
    tau = torch.minimum(table_a.tau, table_b.tau)
    ks, (cn, kb, sd) = sort_by_key(
        torch.cat([table_a.keys, table_b.keys], -1),
        torch.cat([table_a.counts, table_b.counts], -1),
        torch.cat([table_a.kb, table_b.kb], -1),
        torch.cat([table_a.seed, table_b.seed], -1))
    seg, _ = segment_ids(ks)
    live = is_live(ks)
    cnt = segment_reduce(torch.where(live, cn, 0.0), seg, "sum", 0.0)
    dup = segment_reduce(live.to(cn.dtype), seg, "sum", 0.0)
    kbm = segment_reduce(torch.where(live, kb, INF), seg, "amin", INF)
    sdm = segment_reduce(torch.where(live, sd, INF), seg, "amin", INF)
    uk = scatter_unique(ks, seg)

    # duplicate-entry clip correction (m hosts -> m-1 extra clips)
    rate = torch.maximum(1.0 / ls, tau)[:, None]
    cnt = cnt + torch.clamp_min(dup - 1.0, 0.0) / rate
    uk_live = is_live(uk)
    cnt = torch.where(uk_live, cnt, 0.0)
    kbm = torch.where(uk_live, kbm, INF)
    sdm = torch.where(uk_live, sdm, INF)

    # eviction randomness is hashed on the round counter: the merged state
    # stores this same round as its step so no later per-chunk eviction can
    # reuse it (max(a, b) + 1 would collide with a future round)
    round_no = table_a.step + table_b.step + 1
    keys_e, counts_e, kb_e, seed_e, tau_e = VZ._evict_to_k(
        uk, cnt, kbm, sdm, tau, k, ls, salt, round_no)
    keys_c, counts_c, kb_c, seed_c = compact_valid(
        is_live(keys_e), keys_e, counts_e, kb_e, seed_e,
        fills=(EMPTY, 0.0, INF, INF))
    return VZ.TableState(
        keys=keys_c[:, :cap], counts=counts_c[:, :cap], kb=kb_c[:, :cap],
        seed=seed_c[:, :cap], tau=tau_e, step=round_no,
        overflow=table_a.overflow + table_b.overflow)


def merge_fixed_k(table_a, table_b, l, salt, *, k):
    """Merge two single-lane fixed-k states ([cap] leaves, scalar tau, step
    and overflow) under a shared threshold: ``merge_fixed_k_multi`` on one
    lane, with ``l`` rounded to f32."""
    ls = torch.tensor([l], dtype=torch.float32, device=table_a.keys.device)
    merged = merge_fixed_k_multi(VZ.TableState(*(x[None] for x in table_a)),
                                 VZ.TableState(*(x[None] for x in table_b)),
                                 ls, salt, k=k)
    return VZ.TableState(*(x[0] for x in merged))


def merge_fixed_k_states(tables, l, salt, *, k):
    """Fold a sequence of single-lane fixed-k states into one (pairwise
    tree)."""
    tables = list(tables)
    if not tables:
        raise ValueError("no states to merge")
    while len(tables) > 1:
        tables = [merge_fixed_k(tables[i], tables[i + 1], l, salt, k=k)
                  if i + 1 < len(tables) else tables[i]
                  for i in range(0, len(tables), 2)]
    return tables[0]


def merge_fixed_k_multi_states(tables, ls, salt, *, k, fold="left"):
    """Fold any subset of stacked multi-l states into one.

    ``fold="left"`` (default) equals a chain of pairwise merges — the fixed-k
    merge is order-sensitive, so the fold shape is part of the answer
    (``MultiSampler.absorb_many`` relies on this to equal repeated
    ``absorb``); ``fold="tree"`` halves the critical path at the cost of that
    equality.  A single state folds to itself."""
    tables = list(tables)
    if not tables:
        raise ValueError("no states to merge")
    if fold == "left":
        acc = tables[0]
        for t in tables[1:]:
            acc = merge_fixed_k_multi(acc, t, ls, salt, k=k)
        return acc
    if fold != "tree":
        raise ValueError(f"unknown fold {fold!r}")
    while len(tables) > 1:
        tables = [merge_fixed_k_multi(tables[i], tables[i + 1], ls, salt, k=k)
                  if i + 1 < len(tables) else tables[i]
                  for i in range(0, len(tables), 2)]
    return tables[0]


# ---------------------------------------------------------------------------
# Distributed two-pass sampling: the per-rank bodies
# ---------------------------------------------------------------------------


def _shard_layout(keys_shard, chunk: int, group):
    """Chunk count and the rank's element ids ``shard_eids(rank, arange(n))``."""
    n = keys_shard.shape[0]
    if n % chunk:
        raise ValueError(f"shard length {n} must be a multiple of chunk {chunk}")
    idx = torch.arange(n, dtype=torch.int64, device=keys_shard.device)
    return n // chunk, VZ.shard_eids(dist.get_rank(group), idx)


def _merge_fn(merge: str, multi: bool):
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}: use one of {MERGES}")
    if merge == "tree":
        return tree_merge_bottomk_multi if multi else tree_merge_bottomk
    return allgather_merge_bottomk_multi if multi else allgather_merge_bottomk


def pass1_shard(keys_shard, weights_shard, *, kind, l, salt, k, chunk,
                merge="tree", group=None):
    """Per-rank pass I over the local stream shard (int32 keys, f32 weights
    on the device) plus the cross-rank merge: the bottom-(k+1) (key, seed)
    summary of the whole stream, on every rank (``pass1_scored``, then the
    merge)."""
    merge_fn = _merge_fn(merge, multi=False)
    _, eids = _shard_layout(keys_shard, chunk, group)
    carry = pass1_scored(keys_shard, weights_shard, eids, kind=kind, l=l, salt=salt,
                         cap=k + 1, chunk=chunk)
    return merge_fn(*carry, k + 1, group)


def pass1_scored(keys, weights, eids, *, kind, l, salt, cap, chunk):
    """The bottom-``cap`` (key, seed) summary of a stream of whole chunks
    (int32 keys and eids, f32 weights, on the device), before any merge.
    The stream is scored (``element_scores``: the ``capscore`` kernel for
    ``kind="continuous"`` on a card) in batches of whole chunks, at most
    ``SCORE_BATCH`` elements each; every score is elementwise, so each
    chunk's slice is the score of that chunk alone, and the chunk loop folds
    it into the carry.  Also ``vectorized.sample_two_pass``'s pass I."""
    n_chunks = keys.shape[0] // chunk
    dev = keys.device
    carry = (torch.full((cap,), EMPTY, dtype=torch.int32, device=dev),
             torch.full((cap,), INF, dtype=torch.float32, device=dev))
    for lo, hi in _score_batches(n_chunks, chunk):
        scores = VZ.element_scores(kind, keys[lo:hi], eids[lo:hi], weights[lo:hi], l, salt)
        for a in range(0, hi - lo, chunk):
            carry = VZ.pass1_step_scored(carry, keys[lo + a:lo + a + chunk],
                                         scores[a:a + chunk], cap=cap)
    return carry


def pass2_local(keys_shard, weights_shard, sampled_sorted):
    """This rank's exact weights of the sampled keys, before the sum over
    ranks.  ``sampled_sorted``: [kk] or per-lane [L, kk] sorted sampled
    keys, EMPTY-padded (EMPTY sorts last); f32 weights of that shape.  The
    scatter-add's atomics add in any order on a card, which is exact for
    integer weights."""
    kk = sampled_sorted.shape[-1]
    loc = torch.clamp(searchsorted(sampled_sorted, keys_shard), 0, kk - 1)
    match = (sampled_sorted.gather(-1, loc) == keys_shard) & is_live(keys_shard)
    local = torch.zeros(sampled_sorted.shape, dtype=torch.float32,
                        device=sampled_sorted.device)
    return local.scatter_add_(-1, loc, torch.where(match, weights_shard, 0.0))


def pass2_shard(keys_shard, weights_shard, sampled_sorted, *, group=None):
    """Per-rank exact-weight accumulation plus the sum over ranks (paper
    pass II); the result is equal on every rank."""
    return all_reduce_sum(pass2_local(keys_shard, weights_shard, sampled_sorted),
                          group)


# elements scored per launch in pass I (``capscore_multi``, or ``capscore``
# at one l): the kernels are bandwidth-bound at this size, and the
# [L, SCORE_BATCH] x 4 outputs stay bounded (64 MB at L = 4)
SCORE_BATCH = 1 << 20


def _score_batches(n_chunks: int, chunk: int):
    """(lo, hi) element ranges of whole chunks, ``SCORE_BATCH`` elements at
    most each (one chunk where a chunk is larger)."""
    per_launch = max(1, SCORE_BATCH // chunk)
    for c0 in range(0, n_chunks, per_launch):
        yield c0 * chunk, min(n_chunks, c0 + per_launch) * chunk


def pass1_local_multi(keys_shard, weights_shard, *, ls, salt, k, chunk,
                      group=None):
    """Per-rank pass I for every l of a grid, before any merge: the
    per-lane bottom-(k+1) summaries ([L, k+1] keys, seeds) of this rank's
    shard.  ``ls`` is an f32 [L] tensor on the shard's device.  The shard is
    scored by ``capscore_multi`` (the CUDA kernel on a card) in launches of
    whole chunks, at most ``SCORE_BATCH`` elements each: the element hashes
    are computed once and every lane reuses them.  Scores are elementwise,
    so each chunk's slice of a launch is the score of that chunk alone, and
    the chunk loop folds it into the carry."""
    n_chunks, eids = _shard_layout(keys_shard, chunk, group)
    dev = keys_shard.device
    L, cap = ls.shape[0], k + 1
    # element scores don't depend on tau: inert thresholds, built once
    taus = torch.full((L,), INF, dtype=torch.float32, device=dev)
    carry = (torch.full((L, cap), EMPTY, dtype=torch.int32, device=dev),
             torch.full((L, cap), INF, dtype=torch.float32, device=dev))
    for lo, hi in _score_batches(n_chunks, chunk):
        score, _, _, _ = capscore_multi(keys_shard[lo:hi], eids[lo:hi],
                                        weights_shard[lo:hi], ls, taus, salt)
        for a in range(0, hi - lo, chunk):
            carry = VZ.pass1_step_multi(carry, keys_shard[lo + a:lo + a + chunk],
                                        score[:, a:a + chunk], cap=cap)
    return carry


def pass1_shard_multi(keys_shard, weights_shard, *, ls, salt, k, chunk,
                      merge="tree", group=None):
    """Per-rank pass I for every l of a grid plus the lane-wise cross-rank
    merge.  Returns ([L, k+1] keys, [L, k+1] seeds) of the union."""
    merge_fn = _merge_fn(merge, multi=True)
    ls = torch.as_tensor(np.asarray(ls, np.float32), device=keys_shard.device)
    carry = pass1_local_multi(keys_shard, weights_shard, ls=ls, salt=salt, k=k,
                              chunk=chunk, group=group)
    return merge_fn(*carry, k + 1, group)


def pass2_shard_multi(keys_shard, weights_shard, sampled_sorted, *, group=None):
    """Per-rank exact-weight accumulation for every lane plus one sum over
    ranks; ``sampled_sorted`` is [L, kk].  Returns [L, kk] f32 weights."""
    return pass2_shard(keys_shard, weights_shard, sampled_sorted, group=group)


def _upload(keys, weights, device):
    keys = normalize_keys(keys)
    weights = (np.ones(len(keys), np.float32) if weights is None
               else np.asarray(weights, np.float32).reshape(-1))
    if len(weights) != len(keys):
        raise ValueError(f"weights length {len(weights)} != keys length {len(keys)}")
    return (torch.from_numpy(keys).to(device), torch.from_numpy(weights).to(device))


def _sorted_by_key(skeys, sseeds):
    o = torch.sort(skeys, dim=-1, stable=True).indices
    return skeys.gather(-1, o), sseeds.gather(-1, o)


def make_distributed_two_pass(*, kind, l, salt, k, chunk, merge="tree",
                              group=None, device=None):
    """The distributed two-pass sample at one l, as a program every rank of
    ``group`` (default: the default group) calls on its own shard.

    Returns ``fn(keys, weights=None) -> (sampled_keys [k+1], seeds [k+1],
    weights [k+1])``, equal on every rank: keys sorted ascending
    (EMPTY-padded), their pass-I seeds and exact pass-II weights.  ``keys``
    and ``weights`` are host arrays of this rank's shard, a multiple of
    ``chunk`` long.  ``device=None`` is the CUDA card.
    """
    device = resolve_device(device)
    _merge_fn(merge, multi=False)

    def program(keys, weights=None):
        kd, wd = _upload(keys, weights, device)
        skeys, sseeds = pass1_shard(kd, wd, kind=kind, l=l, salt=salt, k=k,
                                    chunk=chunk, merge=merge, group=group)
        sorted_keys, sorted_seeds = _sorted_by_key(skeys, sseeds)
        return sorted_keys, sorted_seeds, pass2_shard(kd, wd, sorted_keys, group=group)

    return program


def make_distributed_two_pass_multi(*, ls, salt, k, chunk, merge="tree",
                                    group=None, device=None):
    """The exact distributed two-pass sample for every l of the grid in one
    program, which every rank of ``group`` calls on its own shard.

    Returns ``fn(keys, weights=None) -> (sampled_keys [L, k+1], seeds
    [L, k+1], weights [L, k+1])``, equal on every rank; per lane, keys are
    sorted ascending (EMPTY-padded) with their seeds and exact pass-II
    weights.  ``device=None`` is the CUDA card.
    """
    device = resolve_device(device)
    _merge_fn(merge, multi=True)

    def program(keys, weights=None):
        kd, wd = _upload(keys, weights, device)
        skeys, sseeds = pass1_shard_multi(kd, wd, ls=ls, salt=salt, k=k,
                                          chunk=chunk, merge=merge, group=group)
        sorted_keys, sorted_seeds = _sorted_by_key(skeys, sseeds)
        w = pass2_shard_multi(kd, wd, sorted_keys, group=group)
        return sorted_keys, sorted_seeds, w

    return program
