"""Sort-and-segment utilities + first-class query ``Segment`` objects.

Port of ``repro/core/segments.py``.  Two meanings of "segment" live here:

1. **Sorted-run segments**: a chunk is sorted by key once and reduced per
   run of equal keys.  The torch functions work along the last dimension,
   so the same code serves one table ``[n]`` and a stack of lanes
   ``[L, n]`` (the reference's ``vmap`` written as a leading batch dim).
2. **Query segments** (the H in Q(f, H), paper §2): first-class,
   *hashable* predicates over key ids, evaluated on host with numpy.

Conventions: padding key is ``EMPTY = int32 max`` so padded slots sort last.
No function here synchronises with the device: compaction and merges are
written with scatters, gathers and prefix sums of fixed shape.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hashing as H

EMPTY = 2**31 - 1
_EMPTY_INT = EMPTY
_M32 = 0xFFFFFFFF


def is_empty(keys):
    """Canonical "is this slot padding?" test for key arrays (numpy or
    torch), the single point where the EMPTY encoding is compared."""
    return keys == EMPTY


def is_live(keys):
    """Negation of :func:`is_empty`; same contract."""
    return keys != EMPTY


# salt lane for HashBucket segments (disjoint from the sampler salt lanes in
# core.samplers, which start at 0x01)
SALT_SEGMENT = 0x5E


# ---------------------------------------------------------------------------
# Query segments: the H in Q(f, H)
# ---------------------------------------------------------------------------


class Segment:
    """A set of key ids, evaluable as a boolean mask over any key array.

    Subclasses implement ``mask_np(keys) -> bool[len(keys)]`` and are
    hashable/equatable by *content* (or by held-object identity for opaque
    predicates), so compiled per-lane masks can be cached with the Segment
    itself as the cache key — holding the Segment in the cache keeps any
    captured callable alive, which keeps identity-based keys valid.
    """

    def mask_np(self, keys: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class AllKeys(Segment):
    """H = all keys (segment=None everywhere coerces to this)."""

    def mask_np(self, keys):
        return np.ones(len(keys), dtype=bool)

    def __eq__(self, other):
        return type(other) is AllKeys

    def __hash__(self):
        return hash(AllKeys)

    def describe(self):
        return "all"


class IdSet(Segment):
    """Membership in an explicit id set (kept sorted; content-hashed)."""

    def __init__(self, ids):
        self.ids = np.unique(np.asarray(ids).reshape(-1))
        self._digest = hash((len(self.ids), self.ids.tobytes()))

    def mask_np(self, keys):
        # np.isin == the historical estimators._segment_mask id-list semantics
        return np.isin(keys, self.ids)

    def __eq__(self, other):
        return (type(other) is IdSet and self._digest == other._digest
                and np.array_equal(self.ids, other.ids))

    def __hash__(self):
        return self._digest

    def describe(self):
        return f"ids[{len(self.ids)}]"


class Mask(Segment):
    """A precomputed boolean mask aligned with a specific key array.

    This is the historical ``freqfns.exact_statistic`` calling convention;
    the mask length must match the key array it is applied to.
    """

    def __init__(self, mask):
        self.mask = np.asarray(mask, dtype=bool).reshape(-1)
        self._digest = hash((len(self.mask), self.mask.tobytes()))

    def mask_np(self, keys):
        if len(self.mask) != len(keys):
            raise ValueError(
                f"Mask segment of length {len(self.mask)} applied to "
                f"{len(keys)} keys — mask segments are positional; use IdSet/"
                "Predicate/HashBucket for key-id semantics")
        return self.mask

    def __eq__(self, other):
        return (type(other) is Mask and self._digest == other._digest
                and np.array_equal(self.mask, other.mask))

    def __hash__(self):
        return self._digest

    def describe(self):
        return f"mask[{int(self.mask.sum())}/{len(self.mask)}]"


class Predicate(Segment):
    """An arbitrary vectorized predicate over key ids (host-evaluated).

    Equality/hash are by callable identity: two Predicates wrapping the same
    function object compare equal (and hit the same compiled-mask cache);
    distinct lambdas are distinct segments even if textually identical.
    """

    def __init__(self, fn, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "predicate")

    def mask_np(self, keys):
        return np.asarray(self.fn(keys), dtype=bool).reshape(len(keys))

    def __eq__(self, other):
        return type(other) is Predicate and self.fn is other.fn

    def __hash__(self):
        return hash(self.fn)

    def describe(self):
        return self.name


class HashBucket(Segment):
    """H = keys hashing into bucket ``bucket`` of ``n_buckets`` (A/B slices).

    Uses the shared counter-based hashing substrate (core.hashing), so the
    same (n_buckets, bucket, salt) triple selects the same keys on every
    host and backend.
    """

    def __init__(self, n_buckets: int, bucket: int, salt: int = 0):
        if not 0 <= bucket < n_buckets:
            raise ValueError(f"bucket {bucket} not in [0, {n_buckets})")
        self.n_buckets, self.bucket, self.salt = int(n_buckets), int(bucket), int(salt)

    def mask_np(self, keys):
        h = H.hash_combine_np(np.asarray(keys), np.uint32(SALT_SEGMENT),
                              np.uint32(self.salt))
        return (h % np.uint32(self.n_buckets)) == np.uint32(self.bucket)

    def __eq__(self, other):
        return (type(other) is HashBucket
                and (self.n_buckets, self.bucket, self.salt)
                == (other.n_buckets, other.bucket, other.salt))

    def __hash__(self):
        return hash((HashBucket, self.n_buckets, self.bucket, self.salt))

    def describe(self):
        return f"bucket {self.bucket}/{self.n_buckets}"


def as_segment(segment) -> Segment:
    """Coerce every historical ``segment=`` convention to a Segment.

    None -> AllKeys; Segment -> itself; callable -> Predicate; boolean
    array -> positional Mask; any other array-like -> IdSet membership.
    """
    if segment is None:
        return AllKeys()
    if isinstance(segment, Segment):
        return segment
    if callable(segment):
        return Predicate(segment)
    arr = np.asarray(segment)
    if arr.dtype == bool:
        return Mask(arr)
    return IdSet(arr)


def normalize_keys(keys) -> np.ndarray:
    """Validate and convert stream keys to the canonical int32 form.

    Every ingestion surface — the stateful ``observe``/``reconcile`` AND the
    one-shot samplers (``vectorized._prep``) — funnels through this one helper
    so keys can never be *silently* wrapped by an ``np.asarray(keys, np.int32)``
    cast: non-integer dtypes, values outside int32 range, and the reserved
    padding id ``EMPTY`` (int32 max) all raise instead of corrupting the
    per-key randomness.
    """
    arr = np.asarray(keys).reshape(-1)
    if arr.dtype == np.int32:
        out = arr
    else:
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"stream keys must be integers, got dtype {arr.dtype} — "
                "casting floats/objects would silently truncate key ids")
        if arr.size and (arr.min() < -_EMPTY_INT - 1 or arr.max() > _EMPTY_INT):
            bad = arr[(arr < -_EMPTY_INT - 1) | (arr > _EMPTY_INT)][0]
            raise ValueError(
                f"stream key {bad} outside int32 range — int32 is the key "
                "domain of the sketches; remap ids before ingestion")
        out = arr.astype(np.int32)
    if out.size and out.max() == _EMPTY_INT:
        raise ValueError(
            f"stream key {_EMPTY_INT} is the reserved EMPTY padding id — "
            "remap it before ingestion")
    return out


def sort_by_key(keys, *arrays):
    """Stable-sort ``keys`` ascending along the last dim; apply the
    permutation to all ``arrays`` (same shape as ``keys``)."""
    ks, order = torch.sort(keys, dim=-1, stable=True)
    return ks, tuple(a.gather(-1, order) for a in arrays)


def stable_sort_with_perm(keys):
    """The plain stable sort: ``(keys[perm], perm)`` under the stable
    ascending argsort.  The chunksort kernel is held bit-identical to
    exactly this function."""
    ks, perm = torch.sort(keys, stable=True)
    return ks, perm


class ChunkOrder(NamedTuple):
    """The shared sort of one stream chunk: computed ONCE per chunk, consumed
    by every per-lane reduction (aggregate, bottom-k summary, merge).

    ``ks = keys[perm]`` is ascending with EMPTY (int32 max) last; ``seg`` are
    its int32 segment ids; ``ukeys`` the unique keys compacted to the front
    (ascending, EMPTY padded).  ``eids``/``ws`` are the pre-gathered view:
    the chunk's element ids and weights permuted into key order, so scoring
    them emits every per-element score already key-sorted.  A batch of
    chunks [B, C] gives each field per row (``perm`` within its row).
    """

    ks: torch.Tensor     # [C] int32 keys sorted ascending (stable; EMPTY last)
    perm: torch.Tensor   # [C] int64 permutation: ks == keys[perm]
    seg: torch.Tensor    # [C] int32 segment ids of ks (0..n_seg-1)
    ukeys: torch.Tensor  # [C] int32 unique keys, ascending, EMPTY padded
    eids: torch.Tensor | None = None  # [C] element ids in key order
    ws: torch.Tensor | None = None    # [C] weights in key order


def chunk_order(keys, eids=None, weights=None) -> ChunkOrder:
    """Sort a chunk [C] (or each row of a batch [B, C]) by key once; derive
    (permutation, segments, uniques).

    The sort goes through the chunksort op, which the tensor's device
    routes: the plain stable sort on the CPU, the CUDA kernel on a card.
    Pass ``eids``/``weights`` to also attach the pre-gathered view.
    """
    # deferred import: kernels.chunksort's plain version imports this module
    from ..kernels.chunksort.ops import sort_with_perm

    ks, perm = sort_with_perm(keys)
    seg, first = segment_ids(ks)
    (ukeys,) = compact_valid(first, ks, fills=(EMPTY,))
    return ChunkOrder(
        ks=ks, perm=perm, seg=seg, ukeys=ukeys,
        eids=None if eids is None else eids.gather(-1, perm),
        ws=None if weights is None else weights.gather(-1, perm),
    )


def merge_sorted_runs(a, b):
    """Positions of two sorted runs in their stable merged order, along the
    last dim.

    ``a`` and ``b`` must each be sorted ascending.  Returns ``(pos_a,
    pos_b)``: a permutation of ``0..na+nb-1`` such that scattering ``a`` to
    ``pos_a`` and ``b`` to ``pos_b`` yields exactly what a stable sort of
    ``cat([a, b])`` gives (ties: every entry of ``a`` before ``b``'s).  Two
    ``searchsorted`` passes instead of a sort of the union.
    """
    na, nb = a.shape[-1], b.shape[-1]
    pos_a = torch.arange(na, device=a.device) + searchsorted(b, a, side="left")
    pos_b = torch.arange(nb, device=b.device) + searchsorted(a, b, side="right")
    return pos_a, pos_b


def merge_sorted_runs_gather(a, b, out_len: int | None = None):
    """Gather-form merge of two sorted runs: per merged slot, which run and
    which index feeds it.

    Returns ``(from_b, ia, ib)`` with merged[p] = b[ib[p]] if from_b[p] else
    a[ia[p]] — a stable merge (ties: ``a`` first).  ``out_len`` truncates the
    merged view to its first ``out_len`` positions.  Works on ``[..., n]``
    runs with matching leading dims.  The insertion positions of ``b`` are
    strictly increasing, so marking them and prefix-summing gives how many
    b-slots land at or before each merged position.
    """
    na, nb = a.shape[-1], b.shape[-1]
    m = na + nb if out_len is None else min(out_len, na + nb)
    dev = b.device
    pos_b = torch.arange(nb, device=dev) + searchsorted(a, b, side="right")
    ind = torch.zeros(b.shape[:-1] + (m + 1,), dtype=torch.int64, device=dev)
    # out-of-window positions pile onto the sacrificial slot m (sliced off)
    ind.scatter_(-1, torch.clamp(pos_b, max=m), 1)
    ind = ind[..., :m]
    nb_before = torch.cumsum(ind, -1)
    ib = torch.clamp(nb_before - 1, 0, nb - 1)
    from_b = ind > 0
    ia = torch.clamp(torch.arange(m, device=dev) - nb_before, 0, na - 1)
    return from_b, ia, ib


def searchsorted(a, v, side: str = "left"):
    """``searchsorted`` over the last dim (``a`` sorted ascending)."""
    if a.dim() > 1 and v.dim() == 1:
        v = v.expand(a.shape[:-1] + v.shape)
    return torch.searchsorted(a.contiguous(), v.contiguous(),
                              right=(side == "right"))


def _f32_order_key(x):
    """f32 -> int64 holding the standard monotone uint32 total-order key
    (negatives bit-flipped, non-negatives sign bit set)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where((u >> 31) == 1, (~u) & _M32, u | 0x80000000)


def _f32_from_order_key(key):
    back = torch.where((key >> 31) == 1, key ^ 0x80000000, (~key) & _M32)
    signed = torch.where(back >= 2**31, back - 2**32, back)
    return signed.to(torch.int32).view(torch.float32)


def kth_smallest(x, r):
    """Exact r-th smallest value (0-indexed) of a float32 array along the
    last dim; ``r`` is an int or an integer tensor of the leading shape.

    The reference builds the r-th smallest order key bit by bit; here the
    same monotone f32 -> uint32 key is sorted as an integer and read at rank
    r, which is the same order statistic of the same keys, so the returned
    bits are identical (-0.0 sorts below +0.0 in both).  No float sort and no
    top-k are involved, so no tie-order question arises.
    """
    key = torch.sort(_f32_order_key(x), dim=-1).values
    if isinstance(r, torch.Tensor):
        picked = key.gather(-1, r.to(torch.int64).expand(x.shape[:-1])[..., None])[..., 0]
    else:  # a host int indexes directly: no host scalar copied to the device
        picked = key[..., r]
    return _f32_from_order_key(picked)


def segment_ids(sorted_keys):
    """int32 segment ids (0..n_seg-1) of a key array sorted along its last
    dim, plus the first-of-segment flags; padding gets its own trailing
    segment."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return torch.cumsum(first, -1, dtype=torch.int32) - 1, first


def segment_reduce(vals, seg, reduce, init):
    """Per-segment ``reduce`` ("sum", "amin", "amax") along the last dim into
    as many slots as ``vals`` has entries; empty slots hold ``init`` (the
    reference's ``jax.ops.segment_*`` with ``num_segments`` = length)."""
    out = torch.full_like(vals, init)
    return out.scatter_reduce(-1, seg.to(torch.int64).expand(vals.shape), vals,
                              reduce=reduce, include_self=True)


def scatter_unique(sorted_keys, seg):
    """The unique keys of a key array sorted along its last dim, at
    positions 0..n_seg-1 of an array as long as the input; later slots hold
    ``EMPTY`` (the reference's ``scatter_unique`` without values)."""
    return torch.full_like(sorted_keys, EMPTY).scatter(-1, seg.to(torch.int64),
                                                       sorted_keys)


def compact_valid(valid, *arrays, fills):
    """Move entries with valid=True to the front (stable) along the last
    dim, padding the rest with ``fills``.

    The source map (p-th output slot <- index of the (p+1)-th valid entry)
    is one scatter: valid entry ``i`` owns output slot ``cs[i]-1`` and those
    slots are unique; invalid entries target the sacrificial slot n.
    ``arrays`` broadcast against ``valid`` (a shared ``[n]`` column against
    ``[L, n]`` flags).  Compacting an ascending array yields an ascending
    array, which maintains the sorted-table invariant of core.vectorized.
    """
    n = valid.shape[-1]
    dev = valid.device
    cs = torch.cumsum(valid, -1)
    iota = torch.arange(n, device=dev)
    src = torch.zeros(valid.shape[:-1] + (n + 1,), dtype=torch.int64,
                      device=dev)
    src.scatter_(-1, torch.where(valid, cs - 1, n), iota.expand(valid.shape))
    src = src[..., :n]
    keep = iota < cs[..., -1:]
    out = []
    for a, fill in zip(arrays, fills):
        a = a.expand(valid.shape)
        out.append(torch.where(keep, a.gather(-1, src), fill))
    return tuple(out)


def bottom_k_by(score, k, *arrays, fills):
    """Keep the k entries with smallest score along the last dim; pad the
    rest.  Returns (scores_k, arrays_k...).

    Stable ascending sort, so ties keep the lowest index first — the same
    order as the reference's ``top_k`` of the negated scores.
    """
    _, idx = torch.sort(score, dim=-1, stable=True)
    idx = idx[..., :k]
    sk = score.gather(-1, idx)
    validk = torch.isfinite(sk)
    outs = [sk]
    for a, fill in zip(arrays, fills):
        outs.append(torch.where(validk, a.gather(-1, idx), fill))
    return tuple(outs)
