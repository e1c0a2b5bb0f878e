"""Port parity: the whole slice end to end — ``StreamStatsService`` of the
port against the reference's on the same stream: observe, sketches, one
query batch of cap_T / distinct / total over several segments, hot keys,
the state dict carried between the packages, and the multi-host mode
(``merge_many`` exact and approx, ``reconcile``, exact queries and the
reference's validation errors).  A port-only check holds the merged
services' summaries equal to the distributed two-pass program's.

Tolerances (tests/_torch_ref.py): sampled key sets and n_keys exact; tau and
estimates within rtol 1e-5 (they derive from e-derived counts and
thresholds); counts within rtol 1e-5 plus 4 ulp of the largest weight, and
after a cross-host merge plus 4 ulp of the largest pre-merge count sum;
reconciled pass-II weights exact (integer sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import _two_pass_case as case  # noqa: E402
from _torch_ref import (RTOL, assert_counts_close, count_atol,  # noqa: E402
                        merged_count_atol)

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


# ---------------------------------------------------------------------------
# multi-host mode
# ---------------------------------------------------------------------------

HOST_CFG = dict(k=case.K, ls=case.LS, chunk=case.CHUNK, salt=case.SALT)


def _hosts(n_hosts, *, extra=(0, 100, 333)):
    """Per host: a reference and a port service over the same shard (host_id
    = host number), shard lengths not chunk-aligned, integer weights."""
    keys, weights = case.stream(n_hosts)
    shards = []
    for h in range(n_hosts):
        k, w = case.shard(keys, h), case.shard(weights, h)
        shards.append((k[: len(k) - extra[h % 3]], w[: len(w) - extra[h % 3]]))
    refs = [RS.StreamStatsService(RS.StatsConfig(**HOST_CFG, host_id=h))
            for h in range(n_hosts)]
    ports = [TS.StreamStatsService(TS.StatsConfig(**HOST_CFG, host_id=h), device="cpu")
             for h in range(n_hosts)]
    for (k, w), r, p in zip(shards, refs, ports):
        r.observe(k, w)
        p.observe(k, w)
    return shards, refs, ports


def _exact_queries(F, G):
    qs = []
    for seg in (None, G.HashBucket(8, 3, salt=7)):
        qs += [(F.cap(T), seg) for T in (1.0, 2.0, 5.0, 64.0)]
        qs += [(F.distinct(), seg), (F.total(), seg)]
    return qs


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_merge_many_matches_reference(mode):
    shards, refs, ports = _hosts(3)
    tables = [(t.keys, t.counts) for t in (r._sampler.flushed_state().table for r in refs)]
    refs[0].merge_many(refs[1:], mode=mode)
    ports[0].merge_many(ports[1:], mode=mode)
    ref, port = refs[0], ports[0]
    assert ref.n_observed == port.n_observed == sum(len(k) for k, _ in shards)
    rs, ps = ref.sketches(), port.sketches()
    host_atol = count_atol(max(float(np.max(w)) for _, w in shards))
    atol = merged_count_atol(tables, list(rs), [rs[l].keys for l in rs], host_atol)
    for j, l in enumerate(rs):
        assert np.array_equal(rs[l].keys, ps[l].keys), l
        assert_counts_close(ps[l].counts, rs[l].counts, atol[j], f"counts, l={l}")
        assert ps[l].tau == pytest.approx(rs[l].tau, rel=RTOL)
    rk, rsd = ref._sampler.bottomk_summaries()
    pk, psd = port._sampler.bottomk_summaries()
    assert np.array_equal(rk, pk)
    np.testing.assert_allclose(psd, rsd, rtol=RTOL)
    if mode == "approx":
        for svc in (ref, port):
            with pytest.raises(ValueError, match="approx"):
                svc.begin_reconcile()


def test_reconcile_and_exact_queries_match_reference():
    shards, refs, ports = _hosts(3)
    refs[0].merge_many(refs[1:])
    ports[0].merge_many(ports[1:])
    ref, port = refs[0], ports[0]
    for k, w in shards:  # ragged batches, shards in another order
        for lo in range(0, len(k), 700):
            ref.reconcile(k[lo:lo + 700], w[lo:lo + 700])
            port.reconcile(k[lo:lo + 700], w[lo:lo + 700])
    re_, pe = ref.exact_sketches(), port.exact_sketches()
    assert list(re_) == list(pe)
    for l in re_:
        assert pe[l].exact_weights and re_[l].exact_weights
        assert np.array_equal(re_[l].keys, pe[l].keys), l
        assert np.array_equal(re_[l].counts, pe[l].counts), l  # integer sums
        assert pe[l].tau == pytest.approx(re_[l].tau, rel=RTOL)
    r = ref.query_batch(_exact_queries(RF, RG))  # auto: reconcile is complete
    p = port.query_batch(_exact_queries(TF, TG))
    assert np.array_equal(r.n_keys, p.n_keys)
    np.testing.assert_allclose(p.estimates, r.estimates, rtol=RTOL)
    np.testing.assert_allclose(p.stderr, r.stderr, rtol=RTOL)
    forced = port.query_batch(_exact_queries(TF, TG), exact=True)
    assert np.array_equal(forced.estimates, p.estimates)
    one_pass = port.query_batch(_exact_queries(TF, TG), exact=False)
    r1 = ref.query_batch(_exact_queries(RF, RG), exact=False)
    np.testing.assert_allclose(one_pass.estimates, r1.estimates, rtol=RTOL)
    assert port.query_cap(5.0) == pytest.approx(ref.query_cap(5.0), rel=RTOL)
    assert port.campaign_forecast(5.0, exact=True) == pytest.approx(
        ref.campaign_forecast(5.0, exact=True), rel=RTOL)
    assert port.query_distinct(exact=True) == pytest.approx(
        ref.query_distinct(exact=True), rel=RTOL)
    assert port.query_total(exact=False) == pytest.approx(
        ref.query_total(exact=False), rel=RTOL)


def _merge_errors(S, n):
    """The reference's validation cases on ``S`` (service module) fresh
    services; each returns the callable that must raise."""
    cfg = lambda **kw: S.StatsConfig(**HOST_CFG, **kw)  # noqa: E731
    mk = (lambda c: S.StreamStatsService(c, device="cpu")) if S is TS else S.StreamStatsService
    keys = np.arange(n) % 97

    def svc(**kw):
        s_ = mk(cfg(**kw))
        s_.observe(keys)
        return s_

    def exact_after_approx():
        a, b, c = svc(host_id=0), svc(host_id=1), svc(host_id=2)
        a.merge(b, mode="approx")
        return lambda: a.merge(c)

    def overlap_absorbed():
        a, b, c = svc(host_id=0), svc(host_id=1), svc(host_id=1)
        a.merge(b)
        return lambda: a.merge(c)

    def query_before_reconcile():
        a = svc(host_id=0)
        a.reconcile(keys[: n // 2])
        return lambda: a.query_cap(5.0, exact=True)

    def sketches_before_reconcile():
        a = svc(host_id=0)
        a.begin_reconcile()
        return a.exact_sketches

    def reconcile_invalidated():
        a = svc(host_id=0)
        a.reconcile(keys)
        a.observe(keys[:10])
        return lambda: a.reconcile(keys)

    return {
        "no_host_id": (lambda: svc().merge(svc(host_id=1)), "host_id"),
        "overlapping_host_ids": (lambda: svc(host_id=3).merge(svc(host_id=3)),
                                 "distinct host_ids"),
        "overlap_with_absorbed": (overlap_absorbed(), "distinct host_ids"),
        "exact_after_approx": (exact_after_approx(), "approx"),
        "config_mismatch": (lambda: svc(host_id=0).merge(mk(S.StatsConfig(
            k=case.K, ls=case.LS, chunk=case.CHUNK, salt=1, host_id=1))), "identical"),
        "unknown_mode": (lambda: svc(host_id=0).merge(svc(host_id=1), mode="x"),
                         "unknown merge mode"),
        "query_before_reconcile": (query_before_reconcile(), "before reconcile completed"),
        "sketches_before_reconcile": (sketches_before_reconcile(), "no complete exact"),
        "reconcile_invalidated": (reconcile_invalidated(), "invalidated"),
    }


@pytest.mark.parametrize("case_name", ["no_host_id", "overlapping_host_ids",
                                       "overlap_with_absorbed", "exact_after_approx",
                                       "config_mismatch", "unknown_mode",
                                       "query_before_reconcile",
                                       "sketches_before_reconcile",
                                       "reconcile_invalidated"])
def test_multi_host_validation_matches_reference(case_name):
    messages = []
    for S in (RS, TS):
        fn, match = _merge_errors(S, 700)[case_name]
        with pytest.raises(ValueError, match=match) as err:
            fn()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_merged_services_equal_two_pass_program(tmp_path):
    """Port only: P services (host_id = rank) over the program's shards,
    merged exactly, hold the same per-lane bottom-(k+1) summaries as the
    distributed program, and their reconciled weights equal its pass II."""
    P = 4
    keys, weights = case.stream(P)
    svcs = [TS.StreamStatsService(TS.StatsConfig(**HOST_CFG, host_id=r), device="cpu")
            for r in range(P)]
    for r, svc in enumerate(svcs):
        svc.observe(case.shard(keys, r), case.shard(weights, r))
    svcs[0].merge_many(svcs[1:])
    for r in range(P):
        svcs[0].reconcile(case.shard(keys, r), case.shard(weights, r))
    prog = case.run_port_program(P, tmp_path)[0]
    bk_keys, bk_seeds = svcs[0]._sampler.bottomk_summaries()
    exact = svcs[0].exact_sketches()
    for merge in case.MERGES:
        pk = prog[f"multi_{merge}_keys"]
        ps = prog[f"multi_{merge}_seeds"]
        pw = prog[f"multi_{merge}_weights"]
        for j, l in enumerate(case.LS):
            o = np.argsort(bk_keys[j], kind="stable")
            assert np.array_equal(bk_keys[j][o], pk[j]), (merge, l)
            assert np.array_equal(bk_seeds[j][o], ps[j]), (merge, l)
            res = exact[l]
            loc = np.searchsorted(pk[j], res.keys)
            assert np.array_equal(pk[j][loc], res.keys)
            assert np.array_equal(pw[j][loc].astype(np.float64), res.counts), (merge, l)
