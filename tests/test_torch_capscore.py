"""Port parity: the capscore ops — element scoring ``capscore`` (one lane)
and ``capscore_multi`` (a lane grid), and the fused score + per-key
aggregate ``capscore_agg``.

On the CPU the port runs its plain versions, held against the reference's
Pallas kernels (interpret mode) and their XLA duals.  The CUDA kernels are
held against the plain versions on the card in
tests/test_torch_kernels_cuda.py.

Tolerances (see tests/_torch_ref.py for the log1p fact behind them):
``kb``/``kb_min`` are exact (no transcendental); score and delta within 4
ulp; an ``entry`` flip must be explained by a Delta within 4 ulp of the
element's weight; ``entered`` is exact unless a flip
is explained by a Delta within 4 ulp of the element weight; ``min_score``
within 4 ulp; the sums ``w_total``/``contrib`` within rtol 1e-5 (the
kernels reassociate them), and ``contrib`` against the reference also
within 4 ulp of the largest weight where the scan model is held to it
(``count_atol``: a 1-ulp change of Delta near w is a large relative change
of w - Delta).

``capscore_agg_scan_model`` models the CUDA kernel's segmented scan on the
CPU; against the port's plain version it keeps the exact columns exact.
Pass I's batched scoring is held bit-identical to per-chunk scoring.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import (assert_counts_close, assert_rtol,  # noqa: E402
                        assert_ulp_close, count_atol, to_np, ulp_distance)

from repro.kernels.capscore import ops as rops  # noqa: E402
from repro.kernels.capscore.ref import capscore_multi_ref as ref_multi  # noqa: E402
from repro_torch.core.segments import chunk_order  # noqa: E402
from repro_torch.kernels.capscore import ops  # noqa: E402
from repro_torch.kernels.capscore.ref import capscore_multi_ref  # noqa: E402

EMPTY = 2**31 - 1
SALT = 0x5EED


def _chunk(C, L, seed, n_keys=300, empty_tail=0):
    """A key-sorted Zipf chunk (the ChunkOrder view) and lane parameters
    mixing tau = inf, tau*l > 1 and tau*l < 1."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, C) % n_keys).astype(np.int32)
    if empty_tail:
        keys[-empty_tail:] = EMPTY
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = (rng.random(C) * 3 + 0.05).astype(np.float32)
    order = chunk_order(torch.from_numpy(keys), torch.from_numpy(eids),
                        torch.from_numpy(ws))
    ls = np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0][:L], np.float32)
    taus = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2][:L], np.float32)
    return order, ls, taus


def _explain_entered(ent_a, ent_b, order, ls, taus):
    """Every entered flip must come from an element whose Delta lies within
    4 ulp of its weight under one of the two log1p's."""
    _, delta_t, _, _ = capscore_multi_ref(order.ks, order.eids, order.ws,
                                          torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    _, delta_r, _, _ = ref_multi(jnp.asarray(to_np(order.ks)), jnp.asarray(to_np(order.eids)),
                                 jnp.asarray(to_np(order.ws)), jnp.asarray(ls),
                                 jnp.asarray(taus), SALT)
    seg, ws = to_np(order.seg), to_np(order.ws)
    for j, s in zip(*np.nonzero(ent_a != ent_b)):
        elems = np.nonzero(seg == s)[0]
        d = np.minimum(ulp_distance(to_np(delta_t)[j, elems], ws[elems]),
                       ulp_distance(np.asarray(delta_r)[j, elems], ws[elems]))
        i = elems[int(np.argmin(d))]
        assert d.min() <= 4, (
            f"unexplained entered flip, lane {j} key row {s}: deciding pair "
            f"Delta={to_np(delta_t)[j, i]!r} (port) / {np.asarray(delta_r)[j, i]!r} "
            f"(reference) vs w={ws[i]!r}, {int(d.min())} ulp")


@pytest.mark.parametrize("C,L,empty_tail", [(256, 1, 0), (256, 4, 0), (300, 4, 37),
                                            (512, 8, 0)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_agg_matches_reference(C, L, empty_tail, backend):
    order, ls, taus = _chunk(C, L, seed=C + L, empty_tail=empty_tail)
    got = ops.capscore_agg(order.ks, order.eids, order.ws, order.seg,
                           torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    want = rops.capscore_agg(*(jnp.asarray(to_np(a)) for a in
                               (order.ks, order.eids, order.ws, order.seg)),
                             jnp.asarray(ls), jnp.asarray(taus), np.uint32(SALT),
                             backend=backend)
    w_t, ent_t, ctr_t, kb_t, ms_t = (to_np(a) for a in got)
    w_r, ent_r, ctr_r, kb_r, ms_r = (np.asarray(a) for a in want)
    assert np.array_equal(kb_t, kb_r), "kb_min"
    _explain_entered(ent_t, ent_r, order, ls, taus)
    assert_ulp_close(ms_t, ms_r, what="min_score")
    assert_rtol(w_t, w_r, what="w_total")
    same = ent_t == ent_r
    assert_rtol(ctr_t[same], ctr_r[same], what="contrib")


@pytest.mark.parametrize("L", [1, 4])
def test_capscore_multi_ref_matches_reference(L):
    order, ls, taus = _chunk(400, L, seed=9)
    got = capscore_multi_ref(order.ks, order.eids, order.ws, torch.from_numpy(ls),
                             torch.from_numpy(taus), SALT)
    want = ref_multi(*(jnp.asarray(to_np(a)) for a in (order.ks, order.eids, order.ws)),
                     jnp.asarray(ls), jnp.asarray(taus), SALT)
    score_t, delta_t, entry_t, kb_t = (to_np(a) for a in got)
    score_r, delta_r, entry_r, kb_r = (np.asarray(a) for a in want)
    assert np.array_equal(kb_t, kb_r)
    assert_ulp_close(score_t, score_r, what="score")
    assert_ulp_close(delta_t, delta_r, what="delta")
    flips = np.nonzero(entry_t != entry_r)
    ws = to_np(order.ws)
    for j, i in zip(*flips):
        assert min(ulp_distance(delta_t[j, i], ws[i]),
                   ulp_distance(delta_r[j, i], ws[i])) <= 4, (j, i)


def test_cpu_tensor_takes_plain_version():
    order, ls, taus = _chunk(128, 2, seed=1)
    before = ops.capscore_agg_cuda.launches
    ops.capscore_agg(order.ks, order.eids, order.ws, order.seg,
                     torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    assert ops.capscore_agg_cuda.launches == before
    with pytest.raises(ValueError):
        ops.capscore_agg_cuda(order.ks, order.eids, order.ws, order.seg,
                              torch.from_numpy(ls), torch.from_numpy(taus), SALT)


def _elements(N, seed, empty_every=0):
    """Unsorted elements with non-unit weights (some EMPTY keys)."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, N) % 500).astype(np.int32)
    if empty_every:
        keys[::empty_every] = EMPTY
    eids = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    ws = (rng.random(N) * 3 + 0.05).astype(np.float32)
    return keys, eids, ws


def _assert_scores_agree(got, want, ws):
    """score/delta within 4 ulp, kb exact, entry flips explained."""
    score_t, delta_t, entry_t = got[:3]
    score_r, delta_r, entry_r = want[:3]
    assert_ulp_close(score_t, score_r, what="score")
    assert_ulp_close(delta_t, delta_r, what="delta")
    if len(got) == 4:
        assert np.array_equal(got[3], want[3]), "kb"
    assert entry_t.dtype == np.int32
    for idx in zip(*np.nonzero(entry_t != entry_r)):
        w = ws[idx[-1]]
        gap = min(ulp_distance(delta_t[idx], w), ulp_distance(delta_r[idx], w))
        assert gap <= 4, f"unexplained entry flip at {idx}: Delta {delta_t[idx]!r} / {delta_r[idx]!r} vs w={w!r}"


# l = 3.3 and 0.7 are not exact in f32: both packages must round them to f32
# before use (the reference does jnp.float32(l))
@pytest.mark.parametrize("l,tau", [(3.3, 0.5), (3.3, np.inf), (16.0, 1e-3), (0.7, 0.2),
                                   (1.0, 2.0)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_matches_reference(l, tau, backend):
    keys, eids, ws = _elements(300, seed=int(l * 10), empty_every=17)
    got = ops.capscore(*(torch.from_numpy(a) for a in (keys, eids, ws)), l, tau, SALT)
    want = rops.capscore(*(jnp.asarray(a) for a in (keys, eids, ws)), l, tau,
                         np.uint32(SALT), backend=backend)
    _assert_scores_agree([to_np(a) for a in got], [np.asarray(a) for a in want], ws)


@pytest.mark.parametrize("N,L", [(1, 1), (300, 4), (777, 8)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_multi_matches_reference(N, L, backend):
    keys, eids, ws = _elements(N, seed=N + L, empty_every=11)
    ls = np.array([1.0, 3.3, 256.0, 4096.0, 0.7, 64.0, 1024.0, 8.0][:L], np.float32)
    taus = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2][:L], np.float32)
    got = ops.capscore_multi(*(torch.from_numpy(a) for a in (keys, eids, ws, ls, taus)),
                             SALT)
    want = rops.capscore_multi(*(jnp.asarray(a) for a in (keys, eids, ws, ls, taus)),
                               np.uint32(SALT), backend=backend)
    got, want = [to_np(a) for a in got], [np.asarray(a) for a in want]
    assert [a.shape for a in got] == [(L, N)] * 4
    _assert_scores_agree(got, want, ws)


def test_capscore_is_lane_of_capscore_multi():
    """The single-lane plain version is lane j of the grid's, bit for bit."""
    keys, eids, ws = (torch.from_numpy(a) for a in _elements(500, seed=5))
    ls = torch.tensor([3.3, 16.0], dtype=torch.float32)
    taus = torch.tensor([0.5, float("inf")], dtype=torch.float32)
    multi = ops.capscore_multi(keys, eids, ws, ls, taus, SALT)
    for j, (l, tau) in enumerate(((3.3, 0.5), (16.0, float("inf")))):
        single = ops.capscore(keys, eids, ws, l, tau, SALT)
        for a, b in zip(single, multi):
            assert torch.equal(a, b[j])


def test_cpu_tensors_take_plain_scoring():
    keys, eids, ws = (torch.from_numpy(a) for a in _elements(64, seed=2))
    ls = torch.tensor([2.0], dtype=torch.float32)
    before = (ops.capscore_cuda.launches, ops.capscore_multi_cuda.launches)
    ops.capscore(keys, eids, ws, 2.0, 0.5, SALT)
    ops.capscore_multi(keys, eids, ws, ls, ls, SALT)
    assert (ops.capscore_cuda.launches, ops.capscore_multi_cuda.launches) == before
    with pytest.raises(ValueError):
        ops.capscore_cuda(keys, eids, ws, 2.0, 0.5, SALT)
    with pytest.raises(ValueError):
        ops.capscore_multi_cuda(keys, eids, ws, ls, ls, SALT)


# ---------------------------------------------------------------------------
# The capscore_agg kernel's algorithm, modelled on the CPU
# ---------------------------------------------------------------------------
#
# kernels/csrc/capscore_agg.cu reduces a key-sorted chunk in one CTA by a
# segmented inclusive scan of the monoid (head, entered, w, contrib, min):
# the elements of each thread (ITEMS consecutive ones) in order, then a
# shuffle scan up each warp of 32 threads, then warp 0's scan of the warp
# totals with the previous tile's carry in front, then back down each
# thread's elements; the last element of each segment writes its row.  The
# model below takes the same steps in the same order, vectorised over the
# threads, so it checks the formulation, the tiling and the carry here.

_MODEL_THREADS, _MODEL_ITEMS = 512, 4
_INF = float("inf")


def _combine(a, b):
    """Span ``a`` then span ``b``; each (head [...], entered [L, ...],
    w [...], contrib [L, ...], min [L, ...]) aggregated from its last
    segment head.  A span with a head in ``b`` is ``b``."""
    hb = b[0]
    return (a[0] | hb,
            torch.where(hb, b[1], a[1] | b[1]),
            torch.where(hb, b[2], a[2] + b[2]),
            torch.where(hb, b[3], torch.where(a[1], a[3] + b[2], b[3])),
            torch.where(hb, b[4], torch.minimum(a[4], b[4])))


def _identity(L, shape):
    return (torch.zeros(shape, dtype=torch.bool), torch.zeros((L, *shape), dtype=torch.bool),
            torch.zeros(shape), torch.zeros((L, *shape)), torch.full((L, *shape), _INF))


def _take(x, i):
    return tuple(f[..., i] for f in x)


def _shift_up(x, d, fill):
    """Lane i gets lane i - d along the last dim (``__shfl_up_sync``)."""
    return tuple(torch.cat([g[..., :d], f[..., :-d]], -1) for f, g in zip(x, fill))


def _warp_scan(x):
    """Inclusive Kogge-Stone scan along the last dim (32 lanes)."""
    lane = torch.arange(x[0].shape[-1])
    for d in (1, 2, 4, 8, 16):
        o = _shift_up(x, d, x)  # lanes below d keep their own value, unused
        y = _combine(o, x)
        x = tuple(torch.where(lane >= d, yf, xf) for yf, xf in zip(y, x))
    return x


def capscore_agg_scan_model(ks, eids, ws, seg, ls, taus, salt,
                            threads=_MODEL_THREADS, items=_MODEL_ITEMS):
    """The segmented-scan formulation of ``capscore_agg``, in the kernel's
    order of f32 operations."""
    C, L = ks.shape[0], ls.shape[0]
    tile, warps = threads * items, threads // 32
    T = -(-C // tile)
    score, delta, entry, kb = capscore_multi_ref(ks, eids, ws, ls, taus, salt)
    live = ks != EMPTY
    head = torch.ones(C, dtype=torch.bool)
    head[1:] = seg[1:] != seg[:-1]
    end = torch.ones(C, dtype=torch.bool)
    end[:-1] = seg[1:] != seg[:-1]
    es = entry.bool() & live
    elem = (head, es, torch.where(live, ws, 0.0), torch.where(es, ws - delta, 0.0),
            torch.where(live, score, _INF))
    ident = _identity(L, (T * tile - C,))
    elem = tuple(torch.cat([f, g], -1).reshape(*f.shape[:-1], T, warps, 32, items)
                 for f, g in zip(elem, ident))
    # up: each thread's span, each warp's inclusive scan
    span = _take(elem, 0)
    for k in range(1, items):
        span = _combine(span, _take(elem, k))
    incl = _warp_scan(span)
    before = _shift_up(incl, 1, _identity(L, incl[0].shape))
    # warp 0: the warp totals of each tile, the previous tile's carry first
    carry = _identity(L, ())
    prefix = []
    for t in range(T):
        tot = tuple(f[..., t, :] for f in _take(incl, 31))  # [warps]
        lane0 = _combine(carry, _take(tot, 0))
        y = tuple(torch.cat([a[..., None], f[..., 1:]], -1) for a, f in zip(lane0, tot))
        y = _warp_scan(tuple(torch.cat([f, g], -1) for f, g in
                             zip(y, _identity(L, (32 - warps,)))))
        y = _take(y, slice(0, warps))
        ex = _shift_up(y, 1, tuple(f[..., None].expand(*f.shape, warps) for f in carry))
        prefix.append(ex)
        carry = _take(y, warps - 1)
    prefix = tuple(torch.stack([p[i] for p in prefix], -2) for i in range(5))  # [T, warps]
    # down: each element's inclusive aggregate
    run = _combine(tuple(f[..., None] for f in prefix), before)  # [T, warps, 32]
    out = []
    for k in range(items):
        run = _combine(run, _take(elem, k))
        out.append(run)
    incl_elem = tuple(torch.stack([o[i] for o in out], -1).reshape(*out[0][i].shape[:-3], -1)[..., :C]
                      for i in range(5))
    rows = seg[end].to(torch.int64)
    w_total = torch.zeros(C)
    entered = torch.zeros((L, C), dtype=torch.bool)
    contrib = torch.zeros((L, C))
    kb_min = torch.full((L, C), _INF)
    min_score = torch.full((L, C), _INF)
    w_total[rows] = incl_elem[2][end]
    entered[:, rows] = incl_elem[1][:, end]
    contrib[:, rows] = incl_elem[3][:, end]
    kb_min[:, rows] = torch.where(live[end], kb[:, end], _INF)
    min_score[:, rows] = incl_elem[4][:, end]
    return w_total, entered, contrib, kb_min, min_score


def _scan_case(kind, C, L, seed):
    """Key-sorted chunks for the scan model: Zipf keys with a key of 200
    elements straddling the first tile boundary (from 1990), one key filling
    the chunk, an EMPTY tail, or all EMPTY."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, C) % 997).astype(np.int32)
    if kind == "straddle" and C > 2190:
        keys[:1990] = np.arange(1990)
        keys[1990:2190] = 5000
        keys[2190:] = 5001 + keys[2190:]
    elif kind == "one_key":
        keys[:] = 42
    elif kind == "empty_tail":
        keys[-max(1, C // 3):] = EMPTY
    elif kind == "all_empty":
        keys[:] = EMPTY
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = (rng.random(C) * 3 + 0.05).astype(np.float32)
    order = chunk_order(torch.from_numpy(keys), torch.from_numpy(eids), torch.from_numpy(ws))
    ls = np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0], np.float32), L)
    taus = np.resize(np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2],
                              np.float32), L)
    return order, ls, taus


_SCAN_CASES = ([(kind, C) for kind in ("zipf", "straddle") for C in (1, 37, 2048, 5000)]
               + [(kind, C) for kind in ("one_key", "empty_tail", "all_empty")
                  for C in (37, 2048, 5000)])


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("kind,C", _SCAN_CASES)
def test_capscore_agg_scan_model_matches_plain(kind, C, L):
    """The kernel's segmented-scan formulation equals ``capscore_agg_ref``:
    entered, kb_min and min_score bit for bit, the sums within rtol 1e-5."""
    order, ls, taus = _scan_case(kind, C, L, seed=C * 10 + L)
    args = (order.ks, order.eids, order.ws, order.seg, torch.from_numpy(ls),
            torch.from_numpy(taus), SALT)
    got = capscore_agg_scan_model(*args)
    want = ops.capscore_agg_ref(*args)
    for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
        assert torch.equal(got[i], want[i]), name
    for i, name in ((0, "w_total"), (2, "contrib")):
        assert_rtol(to_np(got[i]), to_np(want[i]), what=name)


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("kind,C", [("straddle", 5000), ("zipf", 37), ("one_key", 2048),
                                    ("empty_tail", 2048), ("all_empty", 37)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_agg_scan_model_matches_reference(kind, C, L, backend):
    """The same formulation against the reference's Pallas kernel
    (interpret mode) and its XLA dual, at the cross-package tolerances."""
    order, ls, taus = _scan_case(kind, C, L, seed=C * 10 + L)
    got = capscore_agg_scan_model(order.ks, order.eids, order.ws, order.seg,
                                  torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    want = rops.capscore_agg(*(jnp.asarray(to_np(a)) for a in
                               (order.ks, order.eids, order.ws, order.seg)),
                             jnp.asarray(ls), jnp.asarray(taus), np.uint32(SALT),
                             backend=backend)
    w_t, ent_t, ctr_t, kb_t, ms_t = (to_np(a) for a in got)
    w_r, ent_r, ctr_r, kb_r, ms_r = (np.asarray(a) for a in want)
    assert np.array_equal(kb_t, kb_r), "kb_min"
    _explain_entered(ent_t, ent_r, order, ls, taus)
    assert_ulp_close(ms_t, ms_r, what="min_score")
    assert_rtol(w_t, w_r, what="w_total")
    # contrib carries differences w - Delta: the module's count tolerance
    same = ent_t == ent_r
    slack = np.full(int(same.sum()), count_atol(float(to_np(order.ws).max())))
    assert_counts_close(ctr_t[same], ctr_r[same], slack, what="contrib")


def test_python_constants_match_capscore_agg_cu():
    """``ops.MAX_LANES`` and the scan model's thread and item counts are
    copies of ``capscore_agg.cu``'s constants: read them from the source."""
    import re
    from pathlib import Path

    src = (Path(ops.__file__).resolve().parents[1] / "csrc" / "capscore_agg.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert len(found) == 1, name
        return int(found[0])

    assert ops.MAX_LANES == const("MAX_LANES")
    assert (_MODEL_THREADS, _MODEL_ITEMS) == (const("THREADS"), const("ITEMS"))


# ---------------------------------------------------------------------------
# Distributed pass I scores in launches of up to 2^20 elements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks,chunk", [(19, 1 << 16), (3, 2048)])
def test_pass1_batched_scoring_equals_per_chunk_scoring(n_chunks, chunk, monkeypatch,
                                                        tmp_path):
    """``pass1_local_multi`` scores whole chunks in launches of at most
    ``SCORE_BATCH`` (2^20) elements: ceil(n / 2^20) calls of
    ``capscore_multi``, and the summaries equal, bit for bit, those of
    scoring each chunk on its own (a one-rank gloo group gives the rank)."""
    import torch.distributed as dist
    from repro_torch.core import distributed as TD
    from repro_torch.core import vectorized as VZ

    n = n_chunks * chunk
    rng = np.random.default_rng(n_chunks)
    keys = torch.from_numpy((rng.zipf(1.2, n) % (1 << 16)).astype(np.int32))
    weights = torch.from_numpy((rng.random(n) * 3 + 0.05).astype(np.float32))
    ls = torch.tensor([1.0, 16.0, 256.0, 4096.0], dtype=torch.float32)
    k = 64
    calls = []

    def spy(*args):
        calls.append(args[0].shape[0])
        return ops.capscore_multi(*args)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(TD, "capscore_multi", spy)
        got = TD.pass1_local_multi(keys, weights, ls=ls, salt=SALT, k=k, chunk=chunk)
    finally:
        dist.destroy_process_group()
    assert TD.SCORE_BATCH == 1 << 20
    assert len(calls) == -(-n // TD.SCORE_BATCH)
    assert sum(calls) == n and max(calls) <= TD.SCORE_BATCH

    eids = VZ.shard_eids(0, torch.arange(n, dtype=torch.int64))
    taus = torch.full((4,), float("inf"))
    carry = (torch.full((4, k + 1), EMPTY, dtype=torch.int32),
             torch.full((4, k + 1), float("inf")))
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        score = ops.capscore_multi(keys[sl], eids[sl], weights[sl], ls, taus, SALT)[0]
        carry = VZ.pass1_step_multi(carry, keys[sl], score, cap=k + 1)
    assert torch.equal(got[0], carry[0]), "summary keys"
    assert torch.equal(got[1], carry[1]), "summary seeds"
