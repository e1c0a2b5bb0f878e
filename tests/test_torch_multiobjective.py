"""Port parity: multi-objective samples (repro_torch.core.multiobjective,
paper §6) against the reference's, on the reference's ``zipf_stream``
(20k Zipf(1.5) elements mod 5000).

Tolerances: ``per_key_randomness`` runs in f64 torch; its keys and the key
hashes ``hx`` are exact, its ``y`` (per-key min of -log1p(-u)/w) and ``wx``
(per-key weight sums) within 2 f64 ulp (``log1p`` and the order of the sums
differ between numpy and torch).  Its plain numpy version, and every host
function given the same per-key arrays, equal the reference's exactly.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)

from repro.core import freqfns as RF  # noqa: E402
from repro.core import multiobjective as RM  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import multiobjective as TM  # noqa: E402

LS = (1.0, 16.0, 256.0)
F64_ULP = 2


def _within_ulp(got, want, n=F64_ULP):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    same = got == want  # inf included
    gap = np.abs(np.where(same, 0.0, got - want))
    assert np.all(same | (gap <= n * np.spacing(np.abs(want)))), float(np.max(gap))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("salt", [0, 9])
def test_per_key_randomness(zipf_stream, weighted, salt):
    w = np.random.default_rng(2).random(len(zipf_stream)) * 3 + 0.05 if weighted else None
    ref = RM.per_key_randomness(zipf_stream, w, salt)
    plain = TM.per_key_randomness_np(zipf_stream, w, salt)
    dev = TM.per_key_randomness(zipf_stream, w, salt, device="cpu")
    for r, p in zip(ref, plain):
        assert r.dtype == p.dtype and np.array_equal(r, p)
    ukeys, hx, y, wx = dev
    assert ukeys.dtype == ref[0].dtype and np.array_equal(ukeys, ref[0])
    assert np.array_equal(hx, ref[1])
    _within_ulp(y, ref[2])
    _within_ulp(wx, ref[3])


def test_host_functions_exact(zipf_stream):
    ukeys, hx, y, wx = RM.per_key_randomness(zipf_stream, None, 3)
    for l in LS:
        assert np.array_equal(TM.seed_for_l(hx, y, l), RM.seed_for_l(hx, y, l))
        rs, rt = RM.sample_for_l(ukeys, hx, y, 50, l)
        ts, tt = TM.sample_for_l(ukeys, hx, y, 50, l)
        assert np.array_equal(rs, ts) and rt == tt
    rg, tg = RM.union_sample_grid(ukeys, hx, y, 50, LS), TM.union_sample_grid(ukeys, hx, y, 50, LS)
    assert list(rg) == list(tg)
    for l in LS:
        assert np.array_equal(rg[l][0], tg[l][0]) and rg[l][1] == tg[l][1]
    assert np.array_equal(RM.union_sample_all_l(ukeys, hx, y, 50),
                          TM.union_sample_all_l(ukeys, hx, y, 50))
    # few keys: the whole data is the sample, tau = inf
    s, t = TM.sample_for_l(ukeys[:10], hx[:10], y[:10], 50, 1.0)
    assert len(s) == 10 and math.isinf(t)


@pytest.mark.parametrize("w", [0.5, 1.0, 7.0, 300.0])
def test_combined_inclusion_prob_exact(w):
    for taus in ({1.0: 0.3, 16.0: 0.05}, {1.0: 0.9}, {16.0: 0.01, 256.0: 0.002, 4096.0: 1e-4},
                 {1.0: math.inf, 16.0: 0.1}):
        assert TM.combined_inclusion_prob(w, taus) == RM.combined_inclusion_prob(w, taus)


def test_multiobjective_sample_and_estimate(zipf_stream):
    """End to end: the union, its weights and per-key thresholds equal the
    reference's, and ``estimate_multi`` gives its estimates."""
    ref = RM.multiobjective_sample(zipf_stream, None, 64, LS, salt=5)
    got = TM.multiobjective_sample(zipf_stream, None, 64, LS, salt=5, device="cpu")
    assert np.array_equal(got[0], ref[0])
    _within_ulp(got[1], ref[1])
    # per-key thresholds are seeds of other keys: y-derived ones within 2 ulp
    for g, r in zip(got[2], ref[2], strict=True):
        assert list(g) == list(r)
        _within_ulp(list(g.values()), list(r.values()))
    for l in LS:
        assert np.array_equal(got[3][l][0], ref[3][l][0])
        _within_ulp([got[3][l][1]], [ref[3][l][1]])
    _, counts = np.unique(zipf_stream, return_counts=True)
    for T in (1, 16, 256):
        want = RM.estimate_multi(RF.cap(T), ref[0], ref[1], ref[2])
        est = TM.estimate_multi(TF.cap(T), got[0], got[1], got[2])
        assert est == pytest.approx(want, rel=1e-12)  # f64 Phi of ulp-close inputs
        exact = TF.exact_statistic(TF.cap(T), counts)
        assert abs(est - exact) < 0.5 * exact  # a sane estimate at k = 64
    # Lemma 6.1: E|S_L| <= k ln n
    assert len(got[0]) <= 64 * math.log(len(zipf_stream))


def test_default_device_needs_cuda(zipf_stream):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.per_key_randomness(zipf_stream, None)
