"""Port parity: the whole slice end to end — ``StreamStatsService`` of the
port against the reference's on the same stream: observe, sketches, one
query batch of cap_T / distinct / total over several segments, hot keys,
and the state dict carried between the packages.

Tolerances (tests/_torch_ref.py): sampled key sets and n_keys exact; tau and
estimates within rtol 1e-5 (they derive from e-derived counts and
thresholds); counts within rtol 1e-5 plus 4 ulp of the largest weight.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
from _torch_ref import RTOL, count_atol  # noqa: E402

from repro.core import freqfns as RF  # noqa: E402
from repro.core import segments as RG  # noqa: E402
from repro.stats import service as RS  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import segments as TG  # noqa: E402
from repro_torch.stats import service as TS  # noqa: E402

CFG = dict(k=64, ls=(1.0, 16.0, 256.0), chunk=256, salt=0x5EED)
T_GRID = (1.0, 2.0, 5.0, 20.0, 300.0)


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.2, n) % 2000).astype(np.int64)


def _queries(F, G):
    qs = []
    for seg in (None, G.HashBucket(8, 3, salt=7), G.IdSet(np.arange(0, 2000, 3))):
        qs += [(F.cap(T), seg) for T in T_GRID]
        qs += [(F.distinct(), seg), (F.total(), seg)]
    return qs


def _assert_services_agree(ref, port, max_weight=1.0):
    rs, ps = ref.sketches(), port.sketches()
    assert list(rs) == list(ps)
    for l in rs:
        assert np.array_equal(rs[l].keys, ps[l].keys), l
        np.testing.assert_allclose(ps[l].counts, rs[l].counts, rtol=RTOL,
                                   atol=count_atol(max_weight))
        assert ps[l].tau == pytest.approx(rs[l].tau, rel=RTOL)
    with pytest.warns(RuntimeWarning):  # T far from every lane, once each
        r = ref.query_batch(_queries(RF, RG))
    with pytest.warns(RuntimeWarning):
        p = port.query_batch(_queries(TF, TG))
    assert np.array_equal(r.n_keys, p.n_keys)
    assert np.array_equal(r.lanes, p.lanes)
    np.testing.assert_allclose(p.estimates, r.estimates, rtol=RTOL)
    np.testing.assert_allclose(p.stderr, r.stderr, rtol=RTOL)


@pytest.mark.parametrize("evict_every", [1, 2])
def test_service_end_to_end(evict_every):
    keys = _stream(9 * 256 + 123, seed=evict_every)
    ref = RS.StreamStatsService(RS.StatsConfig(**CFG, evict_every=evict_every))
    port = TS.StreamStatsService(TS.StatsConfig(**CFG, evict_every=evict_every),
                                 device="cpu")
    for lo in range(0, len(keys), 1000):  # unaligned batches
        ref.observe(keys[lo:lo + 1000])
        port.observe(keys[lo:lo + 1000])
    assert ref.n_observed == port.n_observed == len(keys)
    _assert_services_agree(ref, port)
    assert ref.query_cap(300.0) == pytest.approx(port.query_cap(300.0), rel=RTOL)
    assert ref.query_distinct() == pytest.approx(port.query_distinct(), rel=RTOL)
    assert ref.query_total() == pytest.approx(port.query_total(), rel=RTOL)
    assert np.array_equal(ref.hot_keys(10), port.hot_keys(10))


def test_service_weighted_stream():
    rng = np.random.default_rng(4)
    keys = _stream(5 * 256, seed=4)
    w = (rng.random(len(keys)) * 3 + 0.1).astype(np.float32)
    ref = RS.StreamStatsService(RS.StatsConfig(**CFG))
    port = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    ref.observe(keys, w)
    port.observe(keys, w)
    _assert_services_agree(ref, port, max_weight=float(w.max()))


def test_service_state_carried_from_reference():
    """Reference service state -> port service: both continue the stream
    and agree; the port's own state round-trips exactly."""
    keys = _stream(8 * 256, seed=8)
    cut = 3 * 256 + 45
    ref = RS.StreamStatsService(RS.StatsConfig(**CFG))
    ref.observe(keys[:cut])
    port = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    port.load_state_dict(ref.state_dict())
    twin = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    twin.load_state_dict(port.state_dict())
    for svc in (ref, port, twin):
        svc.observe(keys[cut:])
    _assert_services_agree(ref, port)
    for l, res in port.sketches().items():
        other = twin.sketches()[l]
        assert np.array_equal(res.keys, other.keys)
        assert np.array_equal(res.counts, other.counts)
        assert res.tau == other.tau


def test_service_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.StreamStatsService(TS.StatsConfig())


def test_service_rejects_bad_keys():
    port = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    with pytest.raises(ValueError):
        port.observe(np.array([1, 2**31 - 1]))
    with pytest.raises(ValueError):
        port.observe(np.array([2**40]))
    assert port.n_observed == 0
