"""Pass II's deterministic sum (``ops.segment_fold_``) on the CPU.

The reference sums pass II with ``.at[loc].add``, which on the CPU is a
left fold in element order, bit for bit ``np.add.at``.  The port sums at
four places through ``segment_fold_``: ``incremental.pass2_accumulate``
(f64, behind ``StreamStatsService.reconcile``), ``distributed.pass2_local``
(f32), ``vectorized.sample_two_pass``'s counts (f64) and
``multiobjective.per_key_randomness``'s ``wx`` (f64).  Here, with
fractional weights, whose sums are exact in no order but the element
order:

* the plain version against ``np.add.at``, bit for bit (f32 and f64,
  dropped ids, a hot slot, starting from a non-zero accumulator);
* ``sort_grouping`` plus a Python walk of each slot's range in order -- the
  kernel's arithmetic -- against the plain version, bit for bit;
* the four sites against the reference's functions, bit for bit
  (``sample_two_pass``'s against the element-order fold in each
  package's dtype: the reference sums it in f32, the port in f64);
* a spy: no site reaches ``scatter_add_`` / ``index_add_`` except through
  the fold's plain version, so on a CUDA tensor every site launches the
  kernel (the CUDA tests hold the kernel itself).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_ref import to_np  # noqa: E402

from repro.core import distributed as RD  # noqa: E402
from repro.core import incremental as RI  # noqa: E402
from repro.core import multiobjective as RM  # noqa: E402
from repro.core import vectorized as RV  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import incremental as TI  # noqa: E402
from repro_torch.core import multiobjective as TM  # noqa: E402
from repro_torch.core import vectorized as TV  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import segment_fold_ref  # noqa: E402

EMPTY = 2**31 - 1


def _zipf_stream(n, seed, n_keys=500):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, n) % n_keys).astype(np.int64) + 1
    weights = (rng.random(n) * 3 + 0.05).astype(np.float32)
    return keys, weights


FOLD_CASES = ["f32", "f64", "dropped_ids", "hot_slot", "from_nonzero", "one_row", "empty"]


def _fold_case(case):
    rng = np.random.default_rng(FOLD_CASES.index(case))
    dtype = np.float32 if case == "f32" else np.float64
    S, n = 257, 4000
    slot = rng.integers(0, S, n)
    if case == "dropped_ids":
        slot = rng.integers(-30, S + 30, n)
    elif case == "hot_slot":
        slot = np.where(rng.random(n) < 0.18, 7, slot)  # ~18% of the rows
    elif case == "one_row":
        slot, n = slot[:1], 1
    elif case == "empty":
        slot, n = slot[:0], 0
    vals = (rng.random(n) * 3 + 0.05).astype(dtype)
    acc = (rng.random(S).astype(dtype) if case == "from_nonzero" else np.zeros(S, dtype))
    return acc, slot.astype(np.int64), vals


def _np_fold(acc, slot, vals):
    out = acc.copy()
    ok = (slot >= 0) & (slot < len(acc))
    np.add.at(out, slot[ok], vals[ok])
    return out


@pytest.mark.parametrize("case", FOLD_CASES)
def test_plain_fold_is_np_add_at(case):
    acc, slot, vals = _fold_case(case)
    got = torch.from_numpy(acc.copy())
    out = ops.segment_fold_(got, torch.from_numpy(slot), torch.from_numpy(vals))
    assert out is got  # in place
    assert np.array_equal(to_np(got), _np_fold(acc, slot, vals))
    # the plain version runs on a 2-D accumulator through its flat view
    acc2 = torch.from_numpy(np.concatenate([acc, acc]).reshape(2, -1).copy())
    segment_fold_ref(acc2, torch.from_numpy(slot), torch.from_numpy(vals))
    assert np.array_equal(to_np(acc2).reshape(-1),
                          _np_fold(np.concatenate([acc, acc]), slot, vals))


def _kernel_model(acc, slot, vals):
    """The fold kernel's arithmetic: ``sort_grouping``, then each slot's
    rows added to its accumulator in range order, in the accumulator's
    dtype."""
    out = acc.clone()
    S = out.numel()
    perm, offsets = ops.sort_grouping(slot, S)
    for s in range(S):
        a = out[s]
        for i in perm[int(offsets[s]):int(offsets[s + 1])].tolist():
            a = a + vals[i]
        out[s] = a
    return out


@pytest.mark.parametrize("case", ["f32", "f64", "dropped_ids", "hot_slot", "from_nonzero"])
def test_sort_grouping_walk_equals_the_plain_fold(case):
    acc, slot, vals = _fold_case(case)
    a, s, v = (torch.from_numpy(x) for x in (acc, slot, vals))
    want = segment_fold_ref(a.clone(), s, v)
    assert torch.equal(_kernel_model(a, s, v), want)
    perm, offsets = ops.sort_grouping(s, a.numel())
    assert offsets.shape == (a.numel() + 1,) and int(offsets[-1]) == int(
        ((s >= 0) & (s < a.numel())).sum())
    # the order is stable: rows of one slot in ascending row order
    for k in range(0, a.numel(), 37):
        rows = perm[int(offsets[k]):int(offsets[k + 1])]
        assert torch.equal(rows, torch.sort(rows).values)


def test_pass2_accumulate_matches_reference_bit_for_bit():
    keys, weights = _zipf_stream(20_000, 1)
    lane_keys = [np.sort(np.unique(keys[j::3])[:60]).astype(np.int32) for j in range(4)]
    rk, racc = RI.init_pass2(lane_keys)
    tk, tacc = TI.init_pass2(lane_keys, device="cpu")
    for lo in range(0, len(keys), 3001):  # ragged batches, fractional weights
        racc = RI.pass2_accumulate(rk, racc, keys[lo:lo + 3001], weights[lo:lo + 3001])
        tacc = TI.pass2_accumulate(tk, tacc, keys[lo:lo + 3001], weights[lo:lo + 3001])
    assert np.array_equal(to_np(tacc), np.asarray(racc))
    want = np.zeros((4, tacc.shape[1]))
    for j, lk in enumerate(lane_keys):
        m = np.isin(keys, lk)
        np.add.at(want[j], np.searchsorted(lk, keys[m]), weights[m].astype(np.float64))
    assert np.array_equal(to_np(tacc), want)


@pytest.mark.parametrize("lanes", [None, 3])
def test_pass2_local_matches_reference_bit_for_bit(lanes):
    keys, weights = _zipf_stream(12_000, 2)
    keys = keys.astype(np.int32)
    keys[::97] = EMPTY  # padding rows never match
    kk = 80
    pick = lambda j: np.sort(np.unique(keys[keys != EMPTY][j::4])[:kk - 5])  # noqa: E731
    rows = [np.concatenate([pick(j), np.full(5, EMPTY)]).astype(np.int32)
            for j in range(lanes or 1)]
    sampled = np.stack(rows) if lanes else rows[0]
    got = TD.pass2_local(torch.from_numpy(keys), torch.from_numpy(weights),
                         torch.from_numpy(sampled))
    fn = RD.pass2_shard_multi if lanes else RD.pass2_shard
    want = jax.vmap(lambda k, w: fn(k, w, jnp.asarray(sampled), axis_name="x"),
                    axis_name="x")(jnp.asarray(keys)[None], jnp.asarray(weights)[None])[0]
    assert got.dtype == torch.float32
    assert np.array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["distinct", "sh", "discrete"])
def test_sample_two_pass_counts_are_the_element_order_fold(kind):
    """The hash-only kinds sample the same keys in both packages.  The
    reference's pass II here (``vectorized._run_pass2``) folds f32 weights
    into an f32 accumulator, the port's into f64 (as ``sample_two_pass``
    always has): each is bit for bit ``np.add.at`` in its own dtype, and
    the two agree within f32 rounding."""
    keys, weights = _zipf_stream(30_000, 3, n_keys=3000)
    l = {"distinct": 1, "sh": 1e9, "discrete": 8}[kind]
    ref = RV.sample_two_pass(keys, weights, k=200, l=l, kind=kind, salt=5, chunk=256)
    got = TV.sample_two_pass(keys, weights, k=200, l=l, kind=kind, salt=5, chunk=256,
                             device="cpu")
    assert np.array_equal(got.keys, ref.keys)
    m = np.isin(keys, got.keys)
    loc = np.searchsorted(got.keys, keys[m])
    for dtype, counts in ((np.float64, got.counts), (np.float32, ref.counts)):
        want = np.zeros(len(got.keys), dtype)
        np.add.at(want, loc, weights[m].astype(dtype))
        assert np.array_equal(counts, want.astype(np.float64)), dtype
    np.testing.assert_allclose(got.counts, ref.counts, rtol=1e-5)


def test_per_key_randomness_wx_matches_reference_bit_for_bit():
    keys, weights = _zipf_stream(40_000, 4)
    ref = RM.per_key_randomness(keys, weights, 9)
    got = TM.per_key_randomness(keys, weights, 9, device="cpu")
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[3], ref[3])
    assert np.array_equal(got[3], TM.per_key_randomness_np(keys, weights, 9)[3])


def test_no_pass2_site_adds_outside_the_fold(monkeypatch):
    """Every ``scatter_add_`` / ``index_add_`` that a pass-II site reaches is
    the fold's plain version's, and every site calls ``segment_fold_``:
    on a CUDA tensor that wrapper launches the kernel, so no site adds with
    atomics on the card."""
    adds, folds = [], []
    real = {name: getattr(torch.Tensor, name) for name in ("scatter_add_", "index_add_")}

    def spy(name):
        def add(self, *args, **kwargs):
            adds.append((name, inspect.stack()[1].function))
            return real[name](self, *args, **kwargs)
        return add

    for name in real:
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    fold = ops.segment_fold_

    def counting_fold(*args):
        folds.append(inspect.stack()[1].function)
        return fold(*args)

    monkeypatch.setattr(TV, "segment_fold_", counting_fold)
    monkeypatch.setattr(TM, "segment_fold_", counting_fold)
    keys, weights = _zipf_stream(6000, 5)
    lane_keys = [np.sort(np.unique(keys[j::3])[:40]).astype(np.int32) for j in range(2)]
    tk, tacc = TI.init_pass2(lane_keys, device="cpu")
    TI.pass2_accumulate(tk, tacc, keys, weights)
    TD.pass2_local(torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(weights), tk)
    TV.sample_two_pass(keys, weights, k=50, l=1, kind="distinct", chunk=256, device="cpu")
    TM.per_key_randomness(keys, weights, 1, device="cpu")
    assert folds == ["fold_matches_"] * 3 + ["per_key_randomness"]
    assert adds and all(caller == "segment_fold_ref" for _, caller in adds), adds
