"""Port parity: the single-sketch pieces of repro_torch.core.vectorized (the
per-chunk aggregates and their sort-inline oracles, the fixed-threshold and
fixed-k chunk steps, the oracle chunk step, the one-shot samplers) against
the reference's, on the same chunks and streams.

Tolerances (tests/_torch_ref.py): integers, keys, entered flags and KeyBase
exact, and every value of the hash-only kinds (discrete, distinct, sh)
exact; the e-derived f32 values (continuous scores, seeds, thresholds)
within rtol 1e-5; counts within rtol 1e-5 plus 4 ulp of the largest
element weight.  Weighted sums (``w_total``) are held to rtol 1e-5: the two
packages add the same f32 terms in their own orders.  Against the
sequential oracles (Algorithms 1, 2, 4) the one-shot samplers keep the
reference's own tolerances (tests/test_equivalence.py): keys equal, and
continuous counts within rtol 1e-4 / atol 1e-3, hash-only counts exact;
two-pass keys equal, tau and counts within rtol 1e-5.  Against the port's
own oracle routes on the CPU (same formulas, same summation order) the
results are bit-identical.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import RTOL, count_atol, to_np  # noqa: E402

from repro.core import vectorized as RV  # noqa: E402
from repro.kernels.capscore.ref import capscore_multi_ref as ref_multi  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core import vectorized as TV  # noqa: E402
from repro_torch.kernels.capscore.ref import capscore_multi_ref  # noqa: E402

EMPTY = 2**31 - 1
SALT = 0x5EED
KINDS = {"continuous": 5.0, "discrete": 5, "distinct": 1, "sh": 1e9}


def _chunk(C, seed, weighted, n_empty=7):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, C) % 300).astype(np.int32)
    keys[C - n_empty:] = EMPTY
    w = ((rng.random(C) * 2 + 0.1) if weighted else np.ones(C)).astype(np.float32)
    w[C - n_empty:] = 0.0
    eids = np.arange(1000 + seed * C, 1000 + (seed + 1) * C, dtype=np.int32)
    return keys, w, eids


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _lane(x):
    return torch.tensor([x], dtype=torch.float32)


def _close(name, got, want, rule, max_w=1.0):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if rule == "exact":
        assert np.array_equal(got, want), name
        return
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), name
    atol = count_atol(max_w) if rule == "counts" else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=atol, err_msg=name)


def _agg_agrees(port, ref, *, continuous, max_w):
    """A port ChunkAgg (lane columns [1, C]) against a reference one ([C])."""
    e = "close" if continuous else "exact"
    _close("ukeys", port.ukeys, ref.ukeys, "exact")
    _close("entered", port.entered[0], ref.entered, "exact")
    _close("kb", port.kb[0], ref.kb, "exact" if continuous else e)
    _close("min_score", port.min_score[0], ref.min_score, e)
    _close("w_total", port.w_total, ref.w_total, "close")
    _close("contrib", port.contrib[0], ref.contrib, "counts", max_w)


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tau", [math.inf, 0.5, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_continuous(tau, weighted, monkeypatch):
    """Finite tau in both regimes (tau*l > 1 and < 1) and the warm-up."""
    l = 5.0
    keys, w, eids = _chunk(512, 1 + weighted, weighted)
    k_t, w_t, e_t = _t(keys, w, eids)
    k_j, w_j, e_j = _j(keys, w, eids)
    tau_t, l_t = _lane(tau), _lane(l)
    ref = RV.aggregate_continuous(k_j, w_j, e_j, jnp.float32(tau), jnp.float32(l), jnp.uint32(SALT))
    ref_ref = RV.aggregate_continuous_ref(k_j, w_j, e_j, jnp.float32(tau), jnp.float32(l),
                                          jnp.uint32(SALT))
    got = TV.aggregate_continuous(k_t, w_t, e_t, tau_t, l_t, SALT)
    got_ref = TV.aggregate_continuous_ref(k_t, w_t, e_t, tau_t, l_t, SALT)
    _agg_agrees(got, ref, continuous=True, max_w=float(w.max()))
    _agg_agrees(got_ref, ref_ref, continuous=True, max_w=float(w.max()))
    _bits_equal(got, got_ref)
    # an order without the pre-gathered view gets it gathered: still one
    # capscore_agg launch, the same bits
    calls = []
    real = TV.capscore_agg
    monkeypatch.setattr(TV, "capscore_agg", lambda *a: calls.append(1) or real(*a))
    order = TV.chunk_order(k_t)
    _bits_equal(TV.aggregate_continuous(k_t, w_t, e_t, tau_t, l_t, SALT, order), got)
    assert len(calls) == 1


@pytest.mark.parametrize("kind", ["discrete", "distinct", "sh"])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_discrete(kind, weighted):
    l, tau = KINDS[kind], 0.3
    keys, w, eids = _chunk(512, 3 + weighted, weighted)
    k_t, w_t, e_t = _t(keys, w, eids)
    k_j, w_j, e_j = _j(keys, w, eids)
    args_j = (k_j, w_j, e_j, jnp.float32(tau), kind, jnp.float32(l), jnp.uint32(SALT))
    ref, ref_ref = RV.aggregate_discrete(*args_j), RV.aggregate_discrete_ref(*args_j)
    # the lane column as a tensor (the single sketch's) and as a host number
    for l_arg in (_lane(l), l):
        got = TV.aggregate_discrete(k_t, w_t, e_t, _lane(tau), kind, l_arg, SALT)
        got_ref = TV.aggregate_discrete_ref(k_t, w_t, e_t, _lane(tau), kind, l_arg, SALT)
        _agg_agrees(got, ref, continuous=False, max_w=float(w.max()))
        _agg_agrees(got_ref, ref_ref, continuous=False, max_w=float(w.max()))
        _bits_equal(got, got_ref)


def test_aggregate_continuous_scored():
    ls, taus = np.float32([1.0, 16.0]), np.float32([0.9, 0.2])
    keys, w, eids = _chunk(512, 5, True)
    k_t, w_t, e_t = _t(keys, w, eids)
    k_j, w_j, e_j = _j(keys, w, eids)
    got = TV.aggregate_continuous_scored(
        k_t, w_t, *capscore_multi_ref(k_t, e_t, w_t, *_t(ls, taus), SALT))
    ref_cols = ref_multi(k_j, e_j, w_j, *_j(ls, taus), SALT)
    for j in range(2):
        ref = RV.aggregate_continuous_scored(k_j, w_j, *(c[j] for c in ref_cols))
        one = type(got)(got.ukeys, got.w_total, *(c[j:j + 1] for c in got[2:]))
        _agg_agrees(one, ref, continuous=True, max_w=float(w.max()))


def _tables_agree(port, ref, *, continuous, max_w=1.0, fixed_k=True):
    """A port single table ([1, cap], [1]) against a reference one; a
    fixed-k tau is an eviction race's (e-derived), a fixed-tau one given."""
    e = "close" if continuous else "exact"
    for name, rule in (("keys", "exact"), ("counts", "counts" if continuous else "exact"),
                       ("kb", "exact" if continuous else e), ("seed", e),
                       ("tau", "close" if fixed_k else "exact"),
                       ("step", "exact"), ("overflow", "exact")):
        got = getattr(port, name)[0]
        _close(name, got, getattr(ref, name), rule, max_w)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fixed_tau_step_chain(kind):
    """Six chunks through both packages' ``fixed_tau_step`` in turn; the
    capacity overflows in the last chunks, counted alike."""
    l, tau = KINDS[kind], 0.2
    rs = RV.init_table(24, jnp.float32(tau))
    ts = TV.init_table(24, tau, device="cpu")
    for c in range(6):
        keys, w, eids = _chunk(256, 10 + c, False)
        rs = RV.fixed_tau_step(rs, *_j(keys, w, eids), jnp.float32(l), jnp.uint32(SALT),
                               kind=kind)
        ts = TV.fixed_tau_step(ts, *_t(keys, w, eids), _lane(l), SALT, kind=kind)
        _tables_agree(ts, rs, continuous=kind == "continuous", fixed_k=False)
    assert int(ts.overflow[0]) > 0


@pytest.mark.parametrize("l", [1.0, 16.0])
def test_fixed_k_step_chain(l):
    k, C = 48, 256
    rs, ts = RV.init_table(k + C), TV.init_table(k + C, device="cpu")
    for c in range(8):
        keys, w, eids = _chunk(C, 20 + c, True)
        rs = RV.fixed_k_step(rs, *_j(keys, w, eids), jnp.float32(l), jnp.uint32(SALT), k=k)
        ts = TV.fixed_k_step(ts, *_t(keys, w, eids), _lane(l), SALT, k=k)
        _tables_agree(ts, rs, continuous=True, max_w=2.1)
    assert np.isfinite(to_np(ts.tau)).all()


def test_fixed_k_step_scored_ref_chain():
    """The oracle chunk step on two stacked lanes against the reference's
    per lane, EMPTY holes of the full-sort eviction included; and the fused
    step reaches the same samples."""
    k, C = 48, 256
    ls = np.float32([1.0, 16.0])
    rst = [RV.init_table(k + C) for _ in ls]
    tst = TV.TableState(*(torch.cat([x, x]) for x in TV.init_table(k + C, device="cpu")))
    fused = tst
    for c in range(8):
        keys, w, eids = _chunk(C, 30 + c, False)
        k_t, w_t, e_t = _t(keys, w, eids)
        k_j, w_j, e_j = _j(keys, w, eids)
        cols = capscore_multi_ref(k_t, e_t, w_t, torch.from_numpy(ls), tst.tau, SALT)
        tst = TV.fixed_k_step_scored_ref(tst, k_t, w_t, *cols, k=k, l=torch.from_numpy(ls),
                                         salt=SALT)
        fcols = capscore_multi_ref(k_t, e_t, w_t, torch.from_numpy(ls), fused.tau, SALT)
        fused = TV.fixed_k_step_scored(fused, k_t, w_t, *fcols, k=k, l=torch.from_numpy(ls),
                                       salt=SALT)
        for j, l in enumerate(ls):
            rcols = ref_multi(k_j, e_j, w_j, jnp.asarray(ls[j:j + 1]),
                              jnp.asarray(rst[j].tau)[None], SALT)
            rst[j] = RV.fixed_k_step_scored_ref(rst[j], k_j, w_j, *(x[0] for x in rcols),
                                                k=k, l=jnp.float32(l), salt=jnp.uint32(SALT))
            _tables_agree(TV.TableState(*(x[j:j + 1] for x in tst)), rst[j], continuous=True)
    for j, l in enumerate(ls):
        a = TV.table_result(TV.TableState(*(x[j:j + 1] for x in tst)), l=l, kind="continuous",
                            tau=0.0)
        b = TV.table_result(TV.TableState(*(x[j:j + 1] for x in fused)), l=l,
                            kind="continuous", tau=0.0)
        assert np.array_equal(a.keys, b.keys) and np.array_equal(a.counts, b.counts)
    assert torch.equal(tst.tau, fused.tau)


@pytest.mark.parametrize("l,tau", [(5.0, 0.02), (1.0, 0.01), (100.0, 0.005)])
def test_sample_fixed_tau_continuous(zipf_stream, l, tau):
    ref = RV.sample_fixed_tau(zipf_stream, None, tau=tau, l=l, salt=7, capacity=16384)
    got = TV.sample_fixed_tau(zipf_stream, None, tau=tau, l=l, salt=7, capacity=16384,
                              device="cpu")
    oracle = TS.alg4_fixed_tau_continuous(zipf_stream, None, tau, l=l, salt=7)
    assert np.array_equal(got.keys, ref.keys)
    np.testing.assert_allclose(got.counts, ref.counts, rtol=RTOL, atol=count_atol(1.0))
    assert np.array_equal(got.keys, oracle.keys)
    np.testing.assert_allclose(got.counts, oracle.counts, rtol=1e-4, atol=1e-3)
    assert (got.tau, got.l, got.kind) == (tau, l, "continuous")


@pytest.mark.parametrize("kind,l", [("discrete", 5), ("distinct", 1), ("sh", math.inf)])
def test_sample_fixed_tau_discrete_family(zipf_stream, kind, l):
    eff_l = 1e9 if math.isinf(l) else l
    ref = RV.sample_fixed_tau(zipf_stream, None, tau=0.02, l=eff_l, kind=kind, salt=7,
                              capacity=16384)
    got = TV.sample_fixed_tau(zipf_stream, None, tau=0.02, l=eff_l, kind=kind, salt=7,
                              capacity=16384, device="cpu")
    oracle = TS.alg2_fixed_tau_discrete(zipf_stream, 0.02, l=l, salt=7, kind=kind)
    for want in (ref, oracle):
        assert np.array_equal(got.keys, want.keys)
        assert np.array_equal(got.counts.astype(np.int64), np.asarray(want.counts, np.int64))


def test_sample_fixed_tau_overflow_raises(zipf_stream):
    with pytest.raises(RuntimeError, match="overflow"):
        TV.sample_fixed_tau(zipf_stream, None, tau=0.5, l=5.0, capacity=64, device="cpu")


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_fixed_k(zipf_stream, weighted):
    w = (np.random.default_rng(4).random(len(zipf_stream)) * 2 + 0.1) if weighted else None
    ref = RV.sample_fixed_k(zipf_stream, w, k=100, l=5.0, salt=3)
    got = TV.sample_fixed_k(zipf_stream, w, k=100, l=5.0, salt=3, device="cpu")
    max_w = 1.0 if w is None else float(np.float32(w).max())
    assert np.array_equal(got.keys, ref.keys)
    np.testing.assert_allclose(got.counts, ref.counts, rtol=RTOL, atol=count_atol(max_w))
    assert got.tau == pytest.approx(ref.tau, rel=RTOL)
    # the reference's own domain checks against the data (distributional
    # equality with Algorithm 5 is the reference's Monte-Carlo claim)
    assert len(got.keys) == 100 and np.all(got.counts > 0)
    ukeys, inv = np.unique(zipf_stream, return_inverse=True)
    totals = np.bincount(inv, weights=np.ones(len(inv)) if w is None else w)
    assert np.all(got.counts <= totals[np.searchsorted(ukeys, got.keys)] + 1e-3)


@pytest.mark.parametrize("kind", list(KINDS))
def test_sample_two_pass(zipf_stream, kind):
    l = KINDS[kind]
    ref = RV.sample_two_pass(zipf_stream, None, k=100, l=l, kind=kind, salt=42)
    got = TV.sample_two_pass(zipf_stream, None, k=100, l=l, kind=kind, salt=42, device="cpu")
    oracle = TS.alg1_two_pass(zipf_stream, None, 100, l=l, kind=kind, salt=42)
    for want in (ref, oracle):
        assert np.array_equal(got.keys, np.sort(want.keys))
        np.testing.assert_allclose(got.tau, want.tau, rtol=1e-5)
        np.testing.assert_allclose(got.counts, want.counts[np.argsort(want.keys)], rtol=1e-5)
    assert got.exact_weights
    ukeys, counts = np.unique(zipf_stream, return_counts=True)
    assert np.array_equal(got.counts, counts[np.searchsorted(ukeys, got.keys)])
    if kind != "continuous":  # hash-only: the threshold is exact too
        assert got.tau == pytest.approx(ref.tau, rel=0, abs=0)


def test_two_pass_pass1_scores_in_batches(zipf_stream, monkeypatch):
    """Pass I of ``sample_two_pass`` calls the ``capscore`` kernel (here its
    plain version) once per ``SCORE_BATCH`` elements, not once per chunk:
    with ``SCORE_BATCH`` cut to 3 chunks, 11 chunks take 4 calls, the last
    of 2 chunks; the sample equals the uncut run's bit for bit."""
    chunk = 256
    keys = zipf_stream[:11 * chunk]
    want = TV.sample_two_pass(keys, k=50, l=5.0, chunk=chunk, device="cpu")
    calls, scorer = [], TV.capscore

    def spy(k, *args):
        calls.append(k.shape[0])
        return scorer(k, *args)

    monkeypatch.setattr(TD, "SCORE_BATCH", 3 * chunk)
    monkeypatch.setattr(TV, "capscore", spy)
    got = TV.sample_two_pass(keys, k=50, l=5.0, chunk=chunk, device="cpu")
    assert calls == [3 * chunk] * 3 + [2 * chunk]
    assert np.array_equal(got.keys, want.keys) and np.array_equal(got.counts, want.counts)
    assert got.tau == want.tau


def test_one_shot_estimates_are_usable(zipf_stream):
    """A two-pass sample feeds the estimators: cap_5 within 5 stderr-free
    percent of the exact statistic at k=1000."""
    from repro_torch.core import estimators as TE

    res = TV.sample_two_pass(zipf_stream, k=1000, l=5.0, salt=9, device="cpu")
    _, counts = np.unique(zipf_stream, return_counts=True)
    exact = TF.exact_statistic(TF.cap(5), counts)
    assert abs(TE.estimate(res, TF.cap(5)) - exact) < 0.05 * exact


def test_default_device_needs_cuda(zipf_stream):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for call in (lambda: TV.sample_fixed_tau(zipf_stream, tau=0.1, l=1.0),
                 lambda: TV.sample_fixed_k(zipf_stream, k=10, l=1.0),
                 lambda: TV.sample_two_pass(zipf_stream, k=10, l=1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
