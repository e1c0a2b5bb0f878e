"""Port parity: the multi-tenant serving plane -- ``MultiTenantStats``,
``QueryEngine.query_batch_async`` / ``PendingBatch``, ``StatsScheduler`` and
the ``stats_serve`` launcher -- against the reference's.

Against the reference (rules of ``tests/_torch_ref.py``): lanes and n_keys
exact, estimates, stderr and CI within rtol 1e-5, for batches mixing
tenants under full, partial and widening refreshes, and for the
scheduler's ``QueryRecord``s driven by the same submissions (the same
completed ids per step; every field but ``latency_s``).  Against the port's
own standalone services: exact.  Port-only: ``PendingBatch`` caches its
result, ``QueueFull`` at ``max_queue_depth``, TTL expiry, and the launcher
at a small size on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
from _torch_ref import RTOL  # noqa: E402

from repro.core import freqfns as RF  # noqa: E402
from repro.core import segments as RG  # noqa: E402
from repro.launch.stats_serve import StatsServer as RServer  # noqa: E402
from repro.stats import scheduler as RSch  # noqa: E402
from repro.stats import service as RS  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import segments as TG  # noqa: E402
from repro_torch.launch.stats_serve import StatsServer as TServer  # noqa: E402
from repro_torch.stats import scheduler as TSch  # noqa: E402
from repro_torch.stats import service as TS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(k=48, ls=(1.0, 8.0, 64.0), chunk=128, salt=0x5EED)
T = 4


def _streams(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.zipf(1.3, n + 97 * t) % 600).astype(np.int64) for t in range(T)]


def _requests(F, G, tenants):
    reqs = []
    for t in tenants:
        for seg in (None, G.HashBucket(8, t % 8)):
            reqs += [(t, F.cap(c), seg) for c in (1.0, 8.0, 64.0)]
        reqs += [(t, F.distinct()), (t, F.total(), None, 8.0)]
    return reqs


def _agree(p, r):
    assert np.array_equal(p.lanes, r.lanes)
    assert np.array_equal(p.n_keys, r.n_keys)
    for name in ("estimates", "stderr", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(p, name), getattr(r, name), rtol=RTOL,
                                   err_msg=name)


def _pair(**kw):
    ref = RS.MultiTenantStats(RS.StatsConfig(**CFG), n_tenants=T, **kw)
    port = TS.MultiTenantStats(TS.StatsConfig(**CFG), n_tenants=T, device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("tenant_salts", [None, [1, 2, 2**32 - 3, 0x5EED]])
def test_mixed_tenant_batches_match_reference(tenant_salts):
    ref, port = _pair(tenant_salts=tenant_salts)
    for t, keys in enumerate(_streams(700, seed=1)):
        for svc in (ref, port):
            svc.observe(t, keys)
    for svc in (ref, port):
        svc.tick()  # a tick, then the rest at refresh (remainders folded too)
    _agree(port.query_batch(_requests(TF, TG, [3, 0, 2])),
           ref.query_batch(_requests(RF, RG, [3, 0, 2])))
    assert port.query_cap(1, 8.0) == pytest.approx(ref.query_cap(1, 8.0), rel=RTOL)
    assert port.query_distinct(2) == pytest.approx(ref.query_distinct(2), rel=RTOL)
    assert port.query_total(0) == pytest.approx(ref.query_total(0), rel=RTOL)
    assert port.resident_bytes == ref.resident_bytes


def test_partial_and_widening_refresh_match_reference():
    ref, port = _pair()
    streams = _streams(600, seed=2)
    for t, keys in enumerate(streams):
        for svc in (ref, port):
            svc.observe(t, keys)
            svc.drain()
    for svc in (ref, port):
        svc.refresh(tenants={0, 1})
        assert svc.has_engine and not svc.stale
    # tenant 3 lies outside the snapshot: the engine widens to {0, 1, 3}
    reqs_p, reqs_r = _requests(TF, TG, [3, 1]), _requests(RF, RG, [3, 1])
    _agree(port.query_batch(reqs_p, auto_refresh=False),
           ref.query_batch(reqs_r, auto_refresh=False))
    assert port._engine_tenants == ref._engine_tenants == {0, 1, 3}
    for svc, keys in ((ref, streams[0]), (port, streams[0])):
        svc.observe(0, keys[:300])
        assert svc.stale
    # without auto_refresh the old snapshot answers; with it, the new state
    _agree(port.query_batch(reqs_p[:4], auto_refresh=False),
           ref.query_batch(reqs_r[:4], auto_refresh=False))
    _agree(port.query_batch(_requests(TF, TG, [0])), ref.query_batch(_requests(RF, RG, [0])))


def test_bank_answers_equal_standalone_services():
    """Bank tenant t answers bit for bit like a standalone port service
    with salt = the tenant's, fed the same stream."""
    salts = [5, 0x5EED, 2**31 + 9, 77]
    port = TS.MultiTenantStats(TS.StatsConfig(**CFG), n_tenants=T, tenant_salts=salts,
                               device="cpu")
    streams = _streams(900, seed=3)
    lone = []
    for t, keys in enumerate(streams):
        port.observe(t, keys)
        svc = TS.StreamStatsService(TS.StatsConfig(**dict(CFG, salt=salts[t])), device="cpu")
        svc.observe(keys)
        lone.append(svc)
    port.drain()
    got = port.query_batch(_requests(TF, TG, range(T)))
    i = 0
    for t in range(T):
        reqs = [r[1:] for r in _requests(TF, TG, [t])]
        want = lone[t].query_batch(reqs)
        n = len(reqs)
        for name in ("estimates", "stderr", "ci_low", "ci_high", "n_keys", "lanes"):
            assert np.array_equal(getattr(got, name)[i:i + n], getattr(want, name)), name
        i += n


def test_pending_batch_caches_its_result():
    _, port = _pair()
    for t, keys in enumerate(_streams(500, seed=4)):
        port.observe(t, keys)
    port.drain()
    reqs = _requests(TF, TG, [0, 2])
    pending = port.query_batch_async(reqs)
    assert len(pending) == len(reqs)
    port.observe(0, _streams(300, seed=5)[0])  # more ingest behind the batch
    port.tick()
    first = pending.result()
    assert pending.result() is first and pending._per_key is None
    want = port.query_batch(reqs, auto_refresh=False)
    assert np.array_equal(first.estimates, want.estimates)


def _drive(sched, F, seed, steps=7):
    """The same submissions to a scheduler of either package: per step a
    few ingest slices and queries (fixed clock); returns the completed ids
    per step and the records."""
    rng = np.random.default_rng(seed)
    done, records = [], {}
    for _ in range(steps):
        for t in rng.choice(T, size=2, replace=False):
            sched.submit_ingest(int(t), (rng.zipf(1.3, 200) % 500).astype(np.int64))
        for _ in range(int(rng.integers(0, 6))):
            sched.submit_query(int(rng.integers(T)), F.cap(float(rng.choice([1.0, 8.0, 64.0]))))
        ids = sched.step()
        done.append(ids)
        records.update({rid: sched.pop_result(rid) for rid in ids})
    ids = sched.drain()
    done.append(ids)
    records.update({rid: sched.pop_result(rid) for rid in ids})
    return done, records


@pytest.mark.parametrize("refresh_every,ticks", [(1, 1), (3, 2)])
def test_scheduler_matches_reference(refresh_every, ticks):
    ref, port = _pair()
    kw = dict(max_ingest_per_step=3, max_queries_per_step=4, refresh_every=refresh_every,
              max_ticks_per_step=ticks)
    clock = lambda: 0.0  # noqa: E731
    rs = RSch.StatsScheduler(ref, RSch.ServeConfig(**kw), clock=clock)
    ps = TSch.StatsScheduler(port, TSch.ServeConfig(**kw), clock=clock)
    rdone, rrec = _drive(rs, RF, seed=refresh_every)
    pdone, prec = _drive(ps, TF, seed=refresh_every)
    assert pdone == rdone and sorted(prec) == sorted(rrec)
    for rid, r in rrec.items():
        p = prec[rid]
        assert (p.req_id, p.tenant, p.lane, p.done_step) == (r.req_id, r.tenant, r.lane,
                                                             r.done_step)
        for name in ("estimate", "stderr", "ci_low", "ci_high"):
            assert getattr(p, name) == pytest.approx(getattr(r, name), rel=RTOL), name
    for name in ("n_elements_ingested", "n_queries_answered", "n_steps"):
        assert getattr(ps, name) == getattr(rs, name), name


def test_scheduler_backpressure_and_ttl():
    _, port = _pair()
    sched = TSch.StatsScheduler(port, TSch.ServeConfig(max_queue_depth=2, result_ttl_steps=2))
    keys = _streams(128, seed=6)[0][:128]
    for _ in range(2):
        sched.submit_ingest(0, keys)
    with pytest.raises(TSch.QueueFull) as ei:
        sched.submit_ingest(0, keys)
    assert ei.value.retriable and (ei.value.plane, ei.value.tenant, ei.value.depth) == (
        "ingest", 0, 2)
    assert sched.pending_ingest == 2
    abandoned = sched.submit_query(0, TF.cap(8.0))
    read = sched.submit_query(0, TF.cap(8.0))
    with pytest.raises(TSch.QueueFull) as ei:
        sched.submit_query(0, TF.cap(8.0))
    assert ei.value.plane == "query"
    sched.submit_query(1, TF.cap(8.0))  # depth is per tenant
    sched.drain()
    assert sched.buffered_results == 3
    assert sched.pop_result(read).done_step == sched.n_steps
    sched.step()
    assert sched.buffered_results == 2  # age 1 < ttl
    sched.step()
    assert sched.buffered_results == 0 and sched.n_results_expired == 2
    assert sched.pop_result(abandoned) is None
    with pytest.raises(ValueError, match="out of range"):
        sched.submit_query(T, TF.cap(1.0))


def test_round_robin_matches_reference():
    from collections import deque

    make = lambda: {0: deque(range(100)), 1: deque(["a"]), 2: deque(),  # noqa: E731
                    3: deque(["b", "c"])}
    for start, budget in ((1, 5), (0, 3), (2, 100)):
        assert (TSch._round_robin(make(), start, 4, budget)
                == RSch._round_robin(make(), start, 4, budget))


def test_stats_server_matches_reference():
    cfg = dict(CFG)
    keys = _streams(1000, seed=7)[0]
    ref = RServer(RS.StreamStatsService(RS.StatsConfig(**cfg)), max_batch=8)
    port = TServer(TS.StreamStatsService(TS.StatsConfig(**cfg), device="cpu"), max_batch=8)
    for server, F in ((ref, RF), (port, TF)):
        for rid in range(20):
            server.submit(rid, F.cap(8.0 if rid % 2 else 64.0))
    assert port.step(keys) == ref.step(keys) == list(range(20))
    assert port.batch_sizes == ref.batch_sizes == [8, 8, 4]
    for rid in range(20):
        p, r = port.pop_result(rid), ref.pop_result(rid)
        assert p["l"] == r["l"] and p["n_keys"] == r["n_keys"]
        assert p["estimate"] == pytest.approx(r["estimate"], rel=RTOL)
    assert port.pop_result(0) is None


def test_stats_serve_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stats_serve", "--device", "cpu",
         "--tenants", "6", "--steps", "4", "--requests", "30", "--k", "32",
         "--chunk", "128", "--stream-batch", "256", "--ingest-per-step", "3"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "queries for 6 tenants" in proc.stdout


def test_stats_serve_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch import stats_serve

    with pytest.raises(RuntimeError, match="CUDA"):
        stats_serve.main(["--tenants", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.MultiTenantStats(TS.StatsConfig(), n_tenants=2)
