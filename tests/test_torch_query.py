"""Port parity: the batched query plane (repro_torch.stats.query.QueryEngine)
is BIT-IDENTICAL to the reference engine and to the scalar estimators on the
same SampleResults.

Tolerance: exact.  The device pass uses only exactly-rounded f64 ops and
the reduction is the same numpy sum on host, so estimates and variances
match bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)

from repro.core import freqfns as RF  # noqa: E402
from repro.core import samplers as RSM  # noqa: E402
from repro.core import segments as RG  # noqa: E402
from repro.stats import query as RQ  # noqa: E402
from repro_torch.core import estimators as TE  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import samplers as TSM  # noqa: E402
from repro_torch.core import segments as TG  # noqa: E402
from repro_torch.stats import query as TQ  # noqa: E402


def _lanes(seed):
    """SampleResults of every provenance the engine routes: 1-pass
    continuous (Thm 5.3), 2-pass inverse probability, tau=inf, discrete."""
    rng = np.random.default_rng(seed)

    def keys(n):
        return np.sort(rng.choice(100_000, n, replace=False)).astype(np.int64)

    out = {}
    for l, tau in ((1.0, 0.004), (16.0, 0.02), (256.0, 0.3)):
        counts = np.round(rng.exponential(l, 300) * 4) / 4 + 0.25
        out[l] = dict(keys=keys(300), counts=counts, tau=tau, l=l, kind="continuous")
    out[4096.0] = dict(keys=keys(200), counts=rng.exponential(50, 200) + 1, tau=0.01,
                       l=4096.0, kind="continuous", exact_weights=True)
    out[7.0] = dict(keys=keys(50), counts=rng.integers(1, 9, 50).astype(np.float64),
                    tau=math.inf, l=7.0, kind="continuous")
    out[3.0] = dict(keys=keys(120), counts=rng.integers(1, 6, 120).astype(np.float64),
                    tau=0.05, l=3.0, kind="discrete")
    return out


def _queries(mod_f, mod_g, lanes):
    fns = [mod_f.cap(1.0), mod_f.cap(5.0), mod_f.cap(37.5), mod_f.distinct(),
           mod_f.total(), mod_f.threshold(3.0), mod_f.moment(2.0), mod_f.log1p()]
    segs = [None, mod_g.HashBucket(4, 1, salt=3), mod_g.IdSet(np.arange(0, 100_000, 7)),
            mod_g.Predicate(_even)]
    return [(fn, seg, l) for l in lanes for fn in fns for seg in segs]


def _even(k):
    return k % 2 == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_bit_identical_to_reference(seed):
    lanes = _lanes(seed)
    ref = RQ.QueryEngine({l: RSM.SampleResult(**d) for l, d in lanes.items()})
    port = TQ.QueryEngine({l: TSM.SampleResult(**d) for l, d in lanes.items()},
                          device="cpu")
    r = ref.query_batch(_queries(RF, RG, lanes))
    p = port.query_batch(_queries(TF, TG, lanes))
    for field in ("estimates", "variances", "stderr", "ci_low", "ci_high", "n_keys",
                  "lanes"):
        a, b = getattr(r, field), getattr(p, field)
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b, equal_nan=True), field


def test_engine_bit_identical_to_scalar_estimators():
    lanes = _lanes(5)
    results = {l: TSM.SampleResult(**d) for l, d in lanes.items()}
    port = TQ.QueryEngine(results, device="cpu")
    qs = _queries(TF, TG, lanes)
    got = port.query_batch(qs).estimates
    for i, (fn, seg, l) in enumerate(qs):
        assert got[i] == TE.estimate(results[l], fn, seg), (fn.name, l)


def test_engine_reuses_banks_and_plans():
    lanes = _lanes(3)
    port = TQ.QueryEngine({l: TSM.SampleResult(**d) for l, d in lanes.items()},
                          device="cpu")
    qs = _queries(TF, TG, lanes)[:20]
    first = port.query_batch(qs)
    rows = len(port._seg_rows)
    again = port.query_batch(qs)
    assert len(port._seg_rows) == rows
    assert np.array_equal(first.estimates, again.estimates)
    with pytest.raises(KeyError):
        port.query_batch([(TF.cap(1.0), None, 999.0)])
