"""Port parity: the sharded ingestion tier (``repro_torch.stats.shardtier``
against ``repro.stats.shardtier``), on the CPU.

Every scenario of the reference's ``tests/test_shardtier.py`` and the tier
half of ``tests/test_fault_tolerance.py`` runs twice, once through each
package, on the same stream and fault schedule.  The scenario's own
assertions (recovery bit-identical to a never-faulted oracle tier of the
same package, coverage stamps, retry and heartbeat accounting) hold in
both; the observations it returns are then held against each other:
coverage, staleness, modes, membership, routed counts, ``status()``
counts and the event kinds exactly, estimates within ``_torch_ref``'s rtol
1e-5 (their seeds and thresholds derive from ``log1p``, which differs
between the frameworks), state dicts under ``assert_state_dicts_agree``.
The reference's own test files fail to import on the installed JAX; these
run it with the ``enable_x64`` alias ``_torch_ref`` sets.

Cross-package: a WAL written by one package replays in the other, and a
shard directory (checkpoint + WAL) written by one package recovers in the
other's ``ShardWorker``, agreeing with the writer's state; the elastic
demos run in both.
"""
import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
from _torch_ref import RTOL, assert_state_dicts_agree, to_np  # noqa: E402

from repro.core import freqfns as RF  # noqa: E402
from repro.core import hashing as RH  # noqa: E402
from repro.launch import elastic as RE  # noqa: E402
from repro.launch import faults as RFa  # noqa: E402
from repro.stats import query as RQ  # noqa: E402
from repro.stats import service as RS  # noqa: E402
from repro.stats import shardtier as RT  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import hashing as TH  # noqa: E402
from repro_torch.launch import elastic as TE  # noqa: E402
from repro_torch.launch import faults as TFa  # noqa: E402
from repro_torch.stats import query as TQ  # noqa: E402
from repro_torch.stats import service as TS  # noqa: E402
from repro_torch.stats import shardtier as TT  # noqa: E402

REF = types.SimpleNamespace(name="reference", F=RF, H=RH, faults=RFa, Q=RQ, S=RS, T=RT,
                            dev={})
PORT = types.SimpleNamespace(name="port", F=TF, H=TH, faults=TFa, Q=TQ, S=TS, T=TT,
                             dev={"device": "cpu"})

CFG = dict(k=64, ls=(1.0, 8.0), chunk=32)


def _cfg(P, **kw):
    return P.S.StatsConfig(**dict(CFG, **kw))


def _queries(P):
    return [P.Q.Query(P.F.distinct()), P.Q.Query(P.F.cap(8.0))]


def _stream(n, lo=1, hi=400, stream_id=0):
    """The reference test's stream: skewed keys from the library hashing."""
    eids = np.arange(n, dtype=np.int64)
    h = RH.hash_combine_np(eids, np.int64(stream_id))
    return (h % np.uint32(hi - lo)).astype(np.int64) + lo


def _weights(n, stream_id=0):
    """Fractional weights in [0.25, 3.25), so pass II's sums are not exact
    in any order but the element order."""
    h = RH.hash_combine_np(np.arange(n, dtype=np.int64), np.int64(stream_id), np.int64(9))
    return (0.25 + RH.uniform01_np(h) * 3.0).astype(np.float32)


def _tier(P, d, faults=None, **kw):
    tier_kw = dict(n_shards=3, checkpoint_every=4, retain_wal=True)
    tier_kw.update(kw)
    return P.T.ShardTier(_cfg(P), P.T.TierConfig(**tier_kw), d, faults=faults, **P.dev)


def _injector(P, events):
    return P.faults.FaultInjector(
        P.faults.FaultSchedule(events=tuple(P.faults.FaultEvent(*e) for e in events)),
        P.faults.VirtualClock())


def _host_state(svc) -> dict:
    return {k: to_np(v) for k, v in svc.state_dict().items()}


def _state_equal(sa: dict, sb: dict) -> bool:
    return (sa.keys() == sb.keys()
            and all(np.array_equal(to_np(sa[k]), to_np(sb[k])) for k in sa))


def _answer(res) -> dict:
    return {"est": np.asarray(res.estimates), "stderr": np.asarray(res.stderr),
            "n_keys": np.asarray(res.n_keys), "coverage": res.coverage,
            "stale": res.staleness_elements, "degraded": res.degraded, "mode": res.mode}


def _status(tier) -> dict:
    """The status plane's states and counts (its clock times left out)."""
    st = tier.status()
    return {"shards": {s: {k: v[k] for k in ("state", "load", "heartbeat_misses", "alive",
                                              "applied_seq", "last_checkpoint_seq",
                                              "wal_depth")}
                       for s, v in st["shards"].items()},
            "coverage": st["coverage"], "n_observed": st["n_observed"],
            "merges": st["merges"], "events": [e[1:3] for e in st["events"]]}


# ---------------------------------------------------------------------------
# Scenarios: each runs in one package and returns its observations
# ---------------------------------------------------------------------------


def sc_route_and_partition(P, d):
    keys = _stream(500)
    a = P.T.route_keys(keys, 4)
    np.testing.assert_array_equal(a, P.T.route_keys(keys, 4))
    assert a.min() >= 0 and a.max() < 4
    solo = np.array([int(P.T.route_keys(np.array([k]), 4)[0]) for k in keys[:50]])
    np.testing.assert_array_equal(solo, a[:50])
    w = np.arange(300, dtype=np.float32)
    parts = P.T.partition_batch(keys[:300], w, 3)
    assert sum(len(pk) for pk, _ in parts) == 300
    sid = P.T.route_keys(keys[:300], 3)
    for s, (pk, pw) in enumerate(parts):
        np.testing.assert_array_equal(pk, keys[:300][sid == s])
        np.testing.assert_array_equal(pw, w[sid == s])
    return {"route": a.tolist(), "parts": [pk.tolist() for pk, _ in parts]}


def sc_wal_roundtrip_truncate_and_gap(P, d):
    wal = P.T.ShardWAL(d)
    for seq in (1, 2, 3, 4):
        wal.append(seq, np.full(seq, seq, np.int32), np.full(seq, float(seq), np.float32))
    assert wal.last_seq() == 4 and wal.covers_from_origin()
    got = [(s, k.tolist()) for s, k, _ in wal.entries(after=2)]
    assert got == [(3, [3, 3, 3]), (4, [4, 4, 4, 4])]
    wal.truncate_through(2)
    assert wal.seqs() == [3, 4] and not wal.covers_from_origin()
    with pytest.raises(ValueError, match="WAL gap"):
        list(wal.entries(after=0))
    (wal.dir / "wal_00000009.npz.tmp").write_bytes(b"torn")
    assert wal.seqs() == [3, 4]
    return {"entries": got, "seqs": wal.seqs()}


def _feed_worker(worker, batches, start_seq=1):
    for seq, b in enumerate(batches, start=start_seq):
        w = _weights(len(b), seq)
        worker.wal.append(seq, b, w)
        worker.apply(seq, b, w)


def sc_worker_crash_recover_bit_identical(P, d):
    batches = [_stream(60, stream_id=i) for i in range(7)]
    ref = P.T.ShardWorker(0, _cfg(P), d + "/ref", checkpoint_every=3, **P.dev)
    _feed_worker(ref, batches)
    w = P.T.ShardWorker(0, _cfg(P), d + "/w", checkpoint_every=3, **P.dev)
    _feed_worker(w, batches[:5])
    w.crash()
    with pytest.raises(P.T.ShardDown):
        w.n_observed
    w.recover()
    _feed_worker(w, batches[5:], start_seq=6)
    assert _state_equal(w.service.state_dict(), ref.service.state_dict())
    w.recover()
    assert _state_equal(w.service.state_dict(), ref.service.state_dict())
    return {"state": _host_state(w.service), "applied": w.applied_seq,
            "ckpt": w._last_ckpt_seq}


def sc_worker_apply_is_idempotent(P, d):
    b = _stream(50)
    w = P.T.ShardWorker(0, _cfg(P), d, checkpoint_every=0, **P.dev)
    w.wal.append(1, b, np.ones(len(b), np.float32))
    w.apply(1, b, np.ones(len(b), np.float32))
    n = w.n_observed
    w.apply(1, b, np.ones(len(b), np.float32))
    assert w.n_observed == n
    with pytest.raises(ValueError, match="gap"):
        w.apply(5, b, np.ones(len(b), np.float32))
    return {"n": n}


def sc_tier_healthy_queries_not_degraded(P, d):
    tier = _tier(P, d)
    for i in range(6):
        tier.ingest(_stream(100, stream_id=i), _weights(100, i))
    res = tier.query_batch(_queries(P))
    assert res.coverage == 1.0 and not res.degraded
    assert res.mode == "approx" and res.staleness_elements == 0
    exact = tier.query_batch(_queries(P), mode="exact")
    assert exact.mode == "exact" and not exact.degraded
    auto = tier.query_batch(_queries(P), mode="auto")
    np.testing.assert_array_equal(auto.estimates, exact.estimates)
    assert auto.mode == "exact"
    return {"approx": _answer(res), "exact": _answer(exact), "status": _status(tier)}


def sc_tier_degraded_flags_and_ht_scaling(P, d):
    tier = _tier(P, d, auto_recover=False)
    for i in range(6):
        tier.ingest(_stream(100, stream_id=i))
    tier.kill_shard(1)
    tier.check_health()
    assert tier.membership()[1] == "down"
    res = tier.query_batch(_queries(P), mode="auto")
    live_routed = tier._routed[0] + tier._routed[2]
    total = sum(tier._routed)
    assert res.degraded and res.mode == "approx"
    assert res.coverage == pytest.approx(live_routed / total)
    assert res.staleness_elements == tier._routed[1]
    raw = tier._merged_approx()[0].query_batch(_queries(P), exact=False)
    np.testing.assert_allclose(res.estimates, raw.estimates / res.coverage)
    assert (res.stderr >= raw.stderr).all()
    with pytest.raises(P.T.ExactUnavailable):
        tier.query_batch(_queries(P), mode="exact")
    assert tier.recover_shard(1)
    back = tier.query_batch(_queries(P), mode="auto")
    assert back.coverage == 1.0 and not back.degraded
    return {"degraded": _answer(res), "back": _answer(back), "status": _status(tier)}


def sc_tier_exact_needs_full_wal(P, d):
    tier = _tier(P, d, retain_wal=False, checkpoint_every=2)
    for i in range(6):
        tier.ingest(_stream(100, stream_id=i))
    with pytest.raises(P.T.ExactUnavailable, match="truncated"):
        tier.query_batch(_queries(P), mode="exact")
    res = tier.query_batch(_queries(P), mode="auto")
    assert res.mode == "approx" and res.coverage == 1.0
    return {"auto": _answer(res), "status": _status(tier)}


def sc_tier_down_shard_keeps_data_and_catches_up(P, d):
    batches = [_stream(100, stream_id=i) for i in range(8)]
    oracle = _tier(P, d + "/oracle")
    tier = _tier(P, d + "/tier", auto_recover=False)
    for b in batches[:4]:
        oracle.ingest(b)
        tier.ingest(b)
    tier.kill_shard(2)
    tier.check_health()
    for b in batches[4:]:
        oracle.ingest(b)
        tier.ingest(b)
    assert tier.recover_shard(2)
    got = tier.query_batch(_queries(P), mode="exact")
    want = oracle.query_batch(_queries(P), mode="exact")
    np.testing.assert_array_equal(got.estimates, want.estimates)
    return {"exact": _answer(got), "status": _status(tier)}


def sc_retry_backoff_on_virtual_clock(P, d):
    inj = _injector(P, [("shard0.ingest", 1, "stall", 0.2), ("shard0.ingest", 2, "stall", 0.2)])
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, retain_wal=True), d,
                         faults=inj, **P.dev)
    keys = _stream(80)
    tier.ingest(keys)
    assert tier.membership()[0] == "up"
    base, factor = tier.tier.backoff_base_s, tier.tier.backoff_factor
    assert tier.clock.now() == pytest.approx(0.2 + 0.2 + base + base * factor)
    assert tier.workers[0].n_observed == len(keys)
    return {"clock": tier.clock.now(), "status": _status(tier)}


def sc_retry_exhaustion_marks_down_then_recovery(P, d):
    inj = _injector(P, [("shard0.ingest", n, "stall", 0.01) for n in range(1, 9)])
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, retain_wal=True,
                                                 auto_recover=False), d, faults=inj, **P.dev)
    keys = _stream(80)
    tier.ingest(keys)
    assert tier.membership()[0] == "down"
    assert any(ev[2] == "down" for ev in tier.events)
    assert tier.recover_shard(0)
    assert tier.workers[0].n_observed == len(keys)
    return {"clock": tier.clock.now(), "status": _status(tier)}


def sc_heartbeat_miss_limit_declares_down(P, d):
    inj = _injector(P, [("shard0.heartbeat", n, "stall", 0.01) for n in range(1, 4)])
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, heartbeat_miss_limit=3,
                                                 auto_recover=False), d, faults=inj, **P.dev)
    tier.ingest(_stream(50))
    tier.check_health()
    tier.check_health()
    assert tier.membership()[0] == "up"
    tier.check_health()
    assert tier.membership()[0] == "down"
    tier.check_health()
    assert tier.membership()[0] == "up"
    return {"status": _status(tier)}


def sc_lost_reply_retry_does_not_double_count(P, d):
    inj = _injector(P, [("shard0.ingest", 1, "lost_reply")])
    ref = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, retain_wal=True), d + "/ref",
                        **P.dev)
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, retain_wal=True), d + "/t",
                         faults=inj, **P.dev)
    keys = _stream(90)
    ref.ingest(keys, _weights(90))
    tier.ingest(keys, _weights(90))
    assert tier.workers[0].n_observed == len(keys)
    got = tier.query_batch(_queries(P), mode="exact")
    want = ref.query_batch(_queries(P), mode="exact")
    np.testing.assert_array_equal(got.estimates, want.estimates)
    return {"exact": _answer(got), "status": _status(tier)}


def sc_merge_many_matches_sequential_pairwise(P, d):
    streams = [_stream(150, stream_id=i) for i in range(3)]
    out = {}
    for mode in ("exact", "approx"):
        svcs = [P.S.StreamStatsService(_cfg(P, host_id=i), **P.dev) for i in range(3)]
        pair = [P.S.StreamStatsService(_cfg(P, host_id=i), **P.dev) for i in range(3)]
        for i in range(3):
            svcs[i].observe(streams[i])
            pair[i].observe(streams[i])
        many = P.S.StreamStatsService(_cfg(P, host_id=9), **P.dev)
        many.merge_many(svcs, mode=mode)
        fold = P.S.StreamStatsService(_cfg(P, host_id=9), **P.dev)
        for p in pair:
            fold.merge(p, mode=mode)
        assert _state_equal(many.state_dict(), fold.state_dict())
        r_many = many.query_batch(_queries(P), exact=False)
        r_fold = fold.query_batch(_queries(P), exact=False)
        np.testing.assert_array_equal(r_many.estimates, r_fold.estimates)
        out[mode] = _answer(r_many)
    return out


def sc_merge_many_validates_group_host_ids(P, d):
    a = P.S.StreamStatsService(_cfg(P, host_id=1), **P.dev)
    b = P.S.StreamStatsService(_cfg(P, host_id=1), **P.dev)
    dst = P.S.StreamStatsService(_cfg(P, host_id=0), **P.dev)
    a.observe(_stream(40))
    b.observe(_stream(40, stream_id=1))
    with pytest.raises(ValueError, match="distinct host_ids"):
        dst.merge_many([a, b], mode="exact")
    dst.merge_many([], mode="exact")
    assert dst.n_observed == 0
    return {"n": dst.n_observed}


def sc_leave_then_join_bit_identical(P, d):
    batches = [_stream(100, stream_id=i) for i in range(6)]
    oracle = _tier(P, d + "/oracle")
    tier = _tier(P, d + "/tier")
    for b in batches[:3]:
        oracle.ingest(b)
        tier.ingest(b)
    tier.leave_shard(0)
    assert tier.membership()[0] == "left"
    with pytest.raises(ValueError):
        tier.recover_shard(0)
    for b in batches[3:]:
        oracle.ingest(b)
        tier.ingest(b)
    left = tier.query_batch(_queries(P))
    assert left.degraded
    assert tier.join_shard(0)
    got = tier.query_batch(_queries(P), mode="exact")
    want = oracle.query_batch(_queries(P), mode="exact")
    np.testing.assert_array_equal(got.estimates, want.estimates)
    assert not tier.query_batch(_queries(P)).degraded
    return {"left": _answer(left), "exact": _answer(got), "status": _status(tier)}


def _truncate_half(path):
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])


def sc_wal_crc_detects_corruption(P, d):
    wal = P.T.ShardWAL(d)
    wal.append(1, np.arange(8, dtype=np.int32), np.ones(8, np.float32))
    p = wal._path(1)
    raw = bytearray(p.read_bytes())
    raw[10] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(P.T.WALCorrupt):
        wal.read_segment(1)
    return {"size": len(raw)}


def sc_wal_torn_tail_repaired_from_buffer(P, d):
    wal = P.T.ShardWAL(d)
    for seq in (1, 2, 3):
        wal.append(seq, np.full(4, seq, np.int32), np.full(4, float(seq), np.float32))
    _truncate_half(wal._path(3))
    got = list(wal.entries())
    assert [s for s, _, _ in got] == [1, 2, 3]
    keys3, _ = wal.read_segment(3)
    np.testing.assert_array_equal(keys3, np.full(4, 3, np.int32))
    return {"seqs": [s for s, _, _ in got]}


def sc_wal_torn_tail_dropped_without_buffer(P, d):
    P.T.ShardWAL(d).append(1, np.ones(4, np.int32), np.ones(4, np.float32))
    wal = P.T.ShardWAL(d)
    wal.append(2, np.full(4, 2, np.int32), np.full(4, 2.0, np.float32))
    wal2 = P.T.ShardWAL(d)
    _truncate_half(wal2._path(2))
    assert wal2.check_tail() == 1
    assert [s for s, _, _ in wal2.entries()] == [1]
    assert wal2.seqs() == [1]
    return {"seqs": wal2.seqs()}


def sc_wal_interior_corruption_raises(P, d):
    wal = P.T.ShardWAL(d)
    for seq in (1, 2, 3):
        wal.append(seq, np.full(4, seq, np.int32), np.full(4, float(seq), np.float32))
    _truncate_half(wal._path(2))
    with pytest.raises(P.T.WALCorrupt):
        list(wal.entries())
    return {}


def sc_torn_tail_recovery_bit_identity(P, d):
    batches = [_stream(100, stream_id=i) for i in range(5)]
    oracle = _tier(P, d + "/oracle")
    tier = _tier(P, d + "/tier")
    for i, b in enumerate(batches):
        oracle.ingest(b, _weights(100, i))
        tier.ingest(b, _weights(100, i))
    wal = tier.workers[1].wal
    _truncate_half(wal._path(wal.last_seq()))
    tier.kill_shard(1)
    tier.check_health()
    assert tier.membership()[1] == "up"
    got = tier.query_batch(_queries(P), mode="exact")
    want = oracle.query_batch(_queries(P), mode="exact")
    np.testing.assert_array_equal(got.estimates, want.estimates)
    return {"exact": _answer(got), "status": _status(tier)}


def sc_slow_but_alive_shard_never_flapped_dead(P, d):
    inj = _injector(P, [("shard0.heartbeat", n, "stall", 0.01) for n in range(1, 7)])
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, heartbeat_miss_limit=3,
                                                 auto_recover=False), d, faults=inj, **P.dev)
    for i in range(6):
        tier.check_health()
        tier.ingest(_stream(50, stream_id=i))
        assert tier.membership()[0] == "up"
    assert not any(e[2] == "down" for e in tier.events)
    assert len(inj.fired) == 6
    return {"status": _status(tier)}


def sc_slow_heartbeats_reset_miss_counter(P, d):
    inj = _injector(P, [("shard0.heartbeat", 1, "stall", 0.01),
                        ("shard0.heartbeat", 2, "stall", 0.01),
                        ("shard0.heartbeat", 3, "slow", 0.5),
                        ("shard0.heartbeat", 4, "stall", 0.01),
                        ("shard0.heartbeat", 5, "stall", 0.01)])
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=1, heartbeat_miss_limit=3,
                                                 auto_recover=False), d, faults=inj, **P.dev)
    tier.ingest(_stream(50))
    for _ in range(5):
        tier.check_health()
    assert tier.membership()[0] == "up"
    assert tier._miss[0] == 2
    return {"status": _status(tier), "clock": tier.clock.now()}


def sc_retry_exhaustion_auto_query_degrades(P, d):
    inj = _injector(P, [("shard1.ingest", n, "stall", 10.0) for n in range(1, 6)])
    tier = P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=3, retain_wal=True,
                                                 auto_recover=False), d, faults=inj, **P.dev)
    for i in range(4):
        tier.ingest(_stream(120, stream_id=i))
    assert tier.membership()[1] == "down"
    res = tier.query_batch(_queries(P), mode="auto")
    assert res.degraded and res.mode == "approx"
    live = sum(tier._routed[s] for s in tier.live_shards())
    total = sum(tier._routed)
    assert res.coverage == pytest.approx(live / total)
    assert res.staleness_elements == total - live
    assert np.all(np.isfinite(res.estimates))
    return {"auto": _answer(res), "status": _status(tier)}


def _degraded_coverage(down_set):
    def sc(P, d):
        tier = _tier(P, d, n_shards=4, auto_recover=False)
        for i in range(6):
            tier.ingest(_stream(150, stream_id=i))
        for s in down_set:
            tier.kill_shard(s)
        tier.check_health()
        res = tier.query_batch(_queries(P), mode="auto")
        live = [s for s in range(4) if s not in down_set]
        assert set(tier.live_shards()) == set(live)
        total = sum(tier._routed)
        covered = sum(tier._routed[s] for s in live)
        assert res.degraded and res.coverage == pytest.approx(covered / total)
        assert res.staleness_elements == total - covered
        for s in down_set:
            assert tier.recover_shard(s)
        back = tier.query_batch(_queries(P), mode="auto")
        assert back.coverage == 1.0
        return {"auto": _answer(res), "back": _answer(back)}
    return sc


def sc_merge_cadence_requires_retain_wal(P, d):
    with pytest.raises(ValueError, match="retain_wal"):
        P.T.ShardTier(_cfg(P), P.T.TierConfig(n_shards=2, retain_wal=False,
                                              merge_every_n_batches=4), d, **P.dev)
    return {}


def sc_merge_cadence_builds_and_refreshes_snapshot(P, d):
    batches = [_stream(100, stream_id=i) for i in range(4)]
    tier = _tier(P, d + "/t", n_shards=2, merge_every_n_batches=2)
    with pytest.raises(P.T.ExactUnavailable):
        tier.query_batch(_queries(P), mode="snapshot")
    tier.ingest(batches[0])
    assert tier._snapshot is None
    tier.ingest(batches[1])
    assert tier._n_merges == 1 and tier.snapshot_staleness() == 0
    snap0 = tier.query_batch(_queries(P), mode="snapshot")
    assert snap0.mode == "snapshot" and not snap0.degraded
    assert snap0.coverage == 1.0 and snap0.staleness_elements == 0
    oracle = _tier(P, d + "/o", n_shards=2)
    oracle.ingest(batches[0])
    oracle.ingest(batches[1])
    want = oracle.query_batch(_queries(P), mode="exact")
    np.testing.assert_array_equal(snap0.estimates, want.estimates)
    tier.ingest(batches[2])
    snap1 = tier.query_batch(_queries(P), mode="snapshot")
    assert snap1.staleness_elements == len(batches[2])
    np.testing.assert_array_equal(snap1.estimates, snap0.estimates)
    assert tier.snapshot_staleness() == len(batches[2])
    tier.ingest(batches[3])
    assert tier._n_merges == 2
    last = tier.query_batch(_queries(P), mode="snapshot")
    assert last.staleness_elements == 0
    return {"snap0": _answer(snap0), "snap1": _answer(snap1), "last": _answer(last),
            "status": _status(tier)}


def sc_merge_every_s_cadence_on_clock(P, d):
    tier = _tier(P, d, n_shards=2, merge_every_s=1.0)
    tier.ingest(_stream(80, stream_id=0))
    assert tier._n_merges == 0
    tier.clock.sleep(1.5)
    tier.ingest(_stream(80, stream_id=1))
    assert tier._n_merges == 1
    return {"status": _status(tier)}


def sc_merge_skipped_while_shard_down(P, d):
    tier = _tier(P, d, n_shards=2, merge_every_n_batches=1, auto_recover=False)
    tier.ingest(_stream(90, stream_id=0))
    assert tier._n_merges == 1
    stale_before = tier.query_batch(_queries(P), mode="snapshot")
    tier.kill_shard(0)
    tier.ingest(_stream(90, stream_id=1))
    assert tier._n_merges == 1 and tier._n_merges_skipped >= 1
    assert any(e[2] == "merge_skipped" for e in tier.events)
    res = tier.query_batch(_queries(P), mode="snapshot")
    assert res.staleness_elements > 0 and not res.degraded
    np.testing.assert_array_equal(res.estimates, stale_before.estimates)
    assert tier.recover_shard(0)
    tier.ingest(_stream(90, stream_id=2))
    assert tier._n_merges == 2
    return {"stale": _answer(res), "status": _status(tier)}


def sc_status_plane_accounting_and_serializable(P, d):
    tier = _tier(P, d, n_shards=3, auto_recover=False)
    for i in range(5):
        tier.ingest(_stream(200, stream_id=i))
    st = tier.status()
    assert st["n_observed"] == tier.n_observed == 1000
    assert sum(s["load"] for s in st["shards"].values()) == 1000
    assert sum(s["share"] for s in st["shards"].values()) == pytest.approx(1.0)
    assert st["coverage"] == 1.0 and st["snapshot"] is None
    for s in range(3):
        w = tier.workers[s]
        assert st["shards"][s]["applied_seq"] == w.applied_seq
        assert st["shards"][s]["wal_depth"] == len(w.wal.seqs())
        assert st["shards"][s]["last_checkpoint_seq"] == w._last_ckpt_seq
    json.dumps(st)
    tier.kill_shard(2)
    tier.check_health()
    st2 = tier.status()
    assert st2["shards"][2]["state"] == "down"
    assert not st2["shards"][2]["alive"]
    assert st2["coverage"] == pytest.approx((tier._routed[0] + tier._routed[1]) / 1000)
    assert any(e[2] == "down" for e in st2["events"])
    json.dumps(st2)
    return {"before": _status(tier), "json": json.loads(json.dumps(st2))["shards"]}


def _chaos(seed):
    """``test_fault_tolerance.py``'s chaos suite: a seeded schedule of
    crashes, stalls, slow calls and lost replies against a fault-free oracle
    tier of the same package; mid-run answers always available; after the
    schedule drains, exact and approx answers bit-identical to the
    oracle's.  Fractional weights, so exact mode's pass II is not exact in
    any order but the element order."""
    def sc(P, d):
        cfg = _cfg(P)
        schedule = P.faults.FaultSchedule.generate(seed, n_shards=3, n_events=12)
        assert schedule.events
        tier_cfg = P.T.TierConfig(n_shards=3, checkpoint_every=4, retain_wal=True,
                                  auto_recover=True)
        n_batches, batch = 8, 250
        eids = np.arange(n_batches * batch, dtype=np.int64)
        keys = ((RH.hash_combine_np(eids, np.int64(5)) % np.uint32(400))
                .astype(np.int64) + 1).reshape(n_batches, batch)
        weights = _weights(n_batches * batch, seed).reshape(n_batches, batch)
        oracle = P.T.ShardTier(cfg, dataclasses.replace(tier_cfg), Path(d) / "oracle",
                               **P.dev)
        tier = P.T.ShardTier(cfg, dataclasses.replace(tier_cfg), Path(d) / "tier",
                             faults=P.faults.FaultInjector(schedule), **P.dev)
        mid = None
        for i, (b, w) in enumerate(zip(keys, weights)):
            oracle.ingest(b, w)
            tier.ingest(b, w)
            if i == n_batches // 2:
                mid = tier.query_batch(_queries(P), mode="auto")
                assert np.all(np.isfinite(mid.estimates))
                if mid.degraded:
                    assert 0.0 < mid.coverage < 1.0 and mid.staleness_elements > 0
                    assert mid.mode == "approx"
                else:
                    assert mid.coverage == 1.0
        got = None
        for _ in range(20):
            try:
                got = tier.query_batch(_queries(P), mode="exact")
                break
            except P.T.ExactUnavailable:
                for _ in range(10):
                    if all(st == "up" for st in tier.check_health().values()):
                        break
        assert got is not None, tier.membership()
        assert got.mode == "exact" and not got.degraded
        assert got.coverage == 1.0 and got.staleness_elements == 0
        want = oracle.query_batch(_queries(P), mode="exact")
        np.testing.assert_array_equal(got.estimates, want.estimates)
        approx = tier.query_batch(_queries(P), mode="approx")
        assert not approx.degraded
        np.testing.assert_array_equal(approx.estimates,
                                      oracle.query_batch(_queries(P), mode="approx").estimates)
        for s in range(3):
            assert _state_equal(tier.workers[s].service.state_dict(),
                                oracle.workers[s].service.state_dict())
        return {"mid": _answer(mid), "exact": _answer(got), "approx": _answer(approx),
                "fired": [(e.site, e.call_no, e.kind) for e in tier._faults.fired],
                "status": _status(tier), "clock": tier.clock.now(),
                "state1": _host_state(tier.workers[1].service)}
    return sc


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_route_and_partition, sc_wal_roundtrip_truncate_and_gap,
    sc_worker_crash_recover_bit_identical, sc_worker_apply_is_idempotent,
    sc_tier_healthy_queries_not_degraded, sc_tier_degraded_flags_and_ht_scaling,
    sc_tier_exact_needs_full_wal, sc_tier_down_shard_keeps_data_and_catches_up,
    sc_retry_backoff_on_virtual_clock, sc_retry_exhaustion_marks_down_then_recovery,
    sc_heartbeat_miss_limit_declares_down, sc_lost_reply_retry_does_not_double_count,
    sc_merge_many_matches_sequential_pairwise, sc_merge_many_validates_group_host_ids,
    sc_leave_then_join_bit_identical, sc_wal_crc_detects_corruption,
    sc_wal_torn_tail_repaired_from_buffer, sc_wal_torn_tail_dropped_without_buffer,
    sc_wal_interior_corruption_raises, sc_torn_tail_recovery_bit_identity,
    sc_slow_but_alive_shard_never_flapped_dead, sc_slow_heartbeats_reset_miss_counter,
    sc_retry_exhaustion_auto_query_degrades, sc_merge_cadence_requires_retain_wal,
    sc_merge_cadence_builds_and_refreshes_snapshot, sc_merge_every_s_cadence_on_clock,
    sc_merge_skipped_while_shard_down, sc_status_plane_accounting_and_serializable)}
for _down in ((1,), (0, 2), (1, 2, 3)):
    SCENARIOS["degraded_coverage_down_" + "_".join(map(str, _down))] = _degraded_coverage(_down)
for _seed in (3, 11, 29):
    SCENARIOS[f"chaos_seed_{_seed}"] = _chaos(_seed)


def _agree(p, r, what):
    """Port observation ``p`` against the reference's ``r``."""
    if isinstance(r, dict) and what.split("/")[-1].startswith("state"):
        assert_state_dicts_agree(p, r, max_weight=3.25, what=what)
    elif isinstance(r, dict):
        assert sorted(map(str, p)) == sorted(map(str, r)), what
        for k in r:
            _agree(p[k], r[k], f"{what}/{k}")
    elif isinstance(r, np.ndarray) and r.dtype.kind == "f":
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=0, err_msg=what)
    elif isinstance(r, np.ndarray):
        np.testing.assert_array_equal(p, r, err_msg=what)
    else:
        assert p == r, (what, p, r)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(tmp_path, name):
    """The scenario's assertions hold in both packages, and the port's
    observations agree with the reference's."""
    obs = {}
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        obs[P.name] = SCENARIOS[name](P, str(d))
    _agree(obs["port"], obs["reference"], name)


# ---------------------------------------------------------------------------
# Cross-package durable state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_segments_are_byte_compatible(tmp_path, writer):
    """A WAL written by one package: the same bytes as the other's, and the
    other replays it, CRC trailers verified."""
    W, R = (PORT, REF) if writer == "port" else (REF, PORT)
    a, b = W.T.ShardWAL(tmp_path / "a"), R.T.ShardWAL(tmp_path / "b")
    for seq in (1, 2, 3):
        keys, w = _stream(37 * seq, stream_id=seq), _weights(37 * seq, seq)
        a.append(seq, keys, w)
        b.append(seq, keys, w)
        assert a._path(seq).read_bytes() == b._path(seq).read_bytes()
    other = R.T.ShardWAL(tmp_path / "a")
    got = list(other.entries())
    assert [s for s, _, _ in got] == [1, 2, 3]
    for seq, keys, w in got:
        np.testing.assert_array_equal(keys, _stream(37 * seq, stream_id=seq).astype(np.int32))
        np.testing.assert_array_equal(w, _weights(37 * seq, seq))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shard_directory_recovers_in_the_other_package(tmp_path, writer):
    """A shard's durable directory (checkpoint + WAL tail past it) written
    by one package's worker: the other package's ``ShardWorker.recover``
    rebuilds it, agrees with the writer's live state, and both continue the
    stream and agree again.  Each package's own recovery is bit-identical
    to its writer's state."""
    W, R = (PORT, REF) if writer == "port" else (REF, PORT)
    batches = [_stream(70, stream_id=i) for i in range(9)]
    w = W.T.ShardWorker(0, _cfg(W), tmp_path, checkpoint_every=4, **W.dev)
    _feed_worker(w, batches[:6])  # checkpoint at seq 4, WAL 5..6 past it
    assert w._last_ckpt_seq == 4
    same = W.T.ShardWorker(0, _cfg(W), tmp_path, checkpoint_every=4, **W.dev)
    assert same.recover() == 6
    assert _state_equal(same.service.state_dict(), w.service.state_dict())
    other = R.T.ShardWorker(0, _cfg(R), tmp_path, checkpoint_every=0, **R.dev)
    assert other.recover() == 6
    p, r = (w, other) if writer == "port" else (other, w)
    assert_state_dicts_agree(_host_state(p.service), _host_state(r.service), max_weight=3.25,
                             what="recovered")
    for seq, b in enumerate(batches[6:], start=7):
        for worker in (w, other):
            worker.apply(seq, b, _weights(len(b), seq))
    assert_state_dicts_agree(_host_state(p.service), _host_state(r.service), max_weight=3.25,
                             what="continued")


def test_stats_handoff_demo_matches_reference():
    got = TE.run_stats_handoff_demo(verbose=False, device="cpu")
    want = RE.run_stats_handoff_demo(verbose=False)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_shard_tier_elastic_demo_matches_reference():
    got = TE.run_shard_tier_elastic_demo(verbose=False, device="cpu")
    want = RE.run_shard_tier_elastic_demo(verbose=False)
    assert got.coverage == want.coverage == 1.0 and not got.degraded
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)


def test_elastic_launcher_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main([])


def test_tier_needs_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.ShardTier(TS.StatsConfig(**CFG), TT.TierConfig(n_shards=2), tmp_path)
