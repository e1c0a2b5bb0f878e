"""Port parity: the sequential oracles, Algorithms 1-5 and their element
scores (repro_torch.core.samplers), against the reference's.

Tolerance: exact.  Both packages run these in host numpy/Python on the same
hashes, so keys, counts, thresholds and scores are equal bit for bit.
The stream is the reference's ``zipf_stream`` fixture (20k Zipf(1.5)
elements mod 5000), cut shorter for the per-element heap walks.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)

from repro.core import samplers as RS  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402


def _same(ro, to):
    assert np.array_equal(ro.keys, to.keys)
    assert ro.keys.dtype == to.keys.dtype
    assert np.array_equal(ro.counts, to.counts) and ro.counts.dtype == to.counts.dtype
    assert ro.tau == to.tau or (math.isnan(ro.tau) and math.isnan(to.tau))
    assert (ro.l, ro.kind, ro.exact_weights) == (to.l, to.kind, to.exact_weights)


def _weights(n, seed):
    return np.random.default_rng(seed).integers(1, 5, n).astype(np.float64)


@pytest.mark.parametrize("weighted", [False, True])
def test_element_scores_bit_identical(zipf_stream, weighted):
    keys = zipf_stream[:5000]
    eids = np.arange(len(keys), dtype=np.int64)
    w = _weights(len(keys), 3) if weighted else np.ones(len(keys))
    for salt in (0, 7, 0xFFFFFFFF):
        pairs = [
            (RS.keybase_np(keys, 5.0, salt), TS.keybase_np(keys, 5.0, salt)),
            (RS.elem_uniform_np(eids, salt), TS.elem_uniform_np(eids, salt)),
            (RS.discrete_score_np(keys, eids, 5, salt), TS.discrete_score_np(keys, eids, 5, salt)),
            (RS.distinct_score_np(keys, salt), TS.distinct_score_np(keys, salt)),
            (RS.sh_score_np(eids, salt), TS.sh_score_np(eids, salt)),
            (RS.continuous_score_np(keys, eids, w, 5.0, salt),
             TS.continuous_score_np(keys, eids, w, 5.0, salt)),
        ]
        for r, t in pairs:
            assert r.dtype == t.dtype and np.array_equal(r, t)


@pytest.mark.parametrize("kind,l", [("continuous", 5.0), ("discrete", 5), ("distinct", 1),
                                    ("sh", 1e9)])
@pytest.mark.parametrize("weighted", [False, True])
def test_alg1_two_pass(zipf_stream, kind, l, weighted):
    w = _weights(len(zipf_stream), 1) if weighted else None
    _same(RS.alg1_two_pass(zipf_stream, w, 100, l=l, kind=kind, salt=42),
          TS.alg1_two_pass(zipf_stream, w, 100, l=l, kind=kind, salt=42))


@pytest.mark.parametrize("kind,l", [("discrete", 5), ("discrete", math.inf), ("distinct", 1),
                                    ("sh", math.inf)])
def test_alg2_fixed_tau_discrete(zipf_stream, kind, l):
    _same(RS.alg2_fixed_tau_discrete(zipf_stream, 0.02, l=l, salt=7, kind=kind),
          TS.alg2_fixed_tau_discrete(zipf_stream, 0.02, l=l, salt=7, kind=kind))


@pytest.mark.parametrize("kind,l", [("discrete", 5), ("discrete", math.inf), ("distinct", 1),
                                    ("sh", math.inf)])
def test_alg3_fixed_k_discrete(zipf_stream, kind, l):
    keys = zipf_stream[:6000]
    _same(RS.alg3_fixed_k_discrete(keys, 100, l=l, salt=11, kind=kind),
          TS.alg3_fixed_k_discrete(keys, 100, l=l, salt=11, kind=kind))


@pytest.mark.parametrize("l,tau", [(5.0, 0.02), (1.0, 0.01), (100.0, 0.005)])
@pytest.mark.parametrize("weighted", [False, True])
def test_alg4_fixed_tau_continuous(zipf_stream, l, tau, weighted):
    w = _weights(len(zipf_stream), 2) if weighted else None
    _same(RS.alg4_fixed_tau_continuous(zipf_stream, w, tau, l=l, salt=7),
          TS.alg4_fixed_tau_continuous(zipf_stream, w, tau, l=l, salt=7))


@pytest.mark.parametrize("batch_evict", [1, 8])
@pytest.mark.parametrize("l", [1.0, 5.0, 100.0])
def test_alg5_fixed_k_continuous(zipf_stream, l, batch_evict):
    keys = zipf_stream[:8000]
    _same(RS.alg5_fixed_k_continuous(keys, None, 100, l=l, salt=5, batch_evict=batch_evict),
          TS.alg5_fixed_k_continuous(keys, None, 100, l=l, salt=5, batch_evict=batch_evict))


def test_invalid_kind_raises():
    keys = np.arange(10)
    with pytest.raises(ValueError):
        TS.alg1_two_pass(keys, None, 3, l=1.0, kind="bogus")
    with pytest.raises(ValueError):
        TS.alg2_fixed_tau_discrete(keys, 0.5, l=1, kind="continuous")
