"""The port's out-of-process shard tier (``repro_torch.stats.procshard``):
real worker subprocesses (``python -m repro_torch.launch.shard_worker
--device cpu``), held bit for bit against the port's in-process
``ShardTier`` over the same stream.

The reference's ``tests/test_procshard.py`` cannot run here (its worker
subprocesses import the reference without the ``enable_x64`` alias), so
the process tier is held against the port's in-process tier, which
``tests/test_torch_shardtier.py`` holds against the reference's:

* a real ``SIGKILL`` mid-stream, restart and recovery: exact answers,
  variances and every shard's state bit-identical to the fault-free
  in-process tier; a second kill past ``max_restarts`` degrades;
* a seeded ``PROC_KINDS`` schedule realized against the processes (kills,
  partitions that sever the socket, stalls, slow calls, lost replies):
  after health rounds converge, exact answers bit-identical;
* the frame protocol (host numpy only, no pickles), and a worker asked for
  the card refusing to start without one.
"""
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import freqfns, hashing  # noqa: E402
from repro_torch.launch.faults import (  # noqa: E402
    PROC_KINDS,
    FaultEvent,
    FaultInjector,
    FaultSchedule,
    WallClock,
)
from repro_torch.stats import procshard  # noqa: E402
from repro_torch.stats.procshard import ProcShardTier, SupervisorConfig  # noqa: E402
from repro_torch.stats.query import Query  # noqa: E402
from repro_torch.stats.service import StatsConfig, StreamStatsService  # noqa: E402
from repro_torch.stats.shardtier import ShardDown, ShardTier, TierConfig  # noqa: E402

CFG = StatsConfig(k=64, ls=(1.0, 8.0), chunk=32)
QUERIES = [Query(freqfns.cap(8.0)), Query(freqfns.distinct()), Query(freqfns.total())]
SRC = Path(__file__).resolve().parents[1] / "src"


def _stream(n, lo, hi, stream_id):
    idx = np.arange(n, dtype=np.int64)
    h = hashing.hash_combine_np(idx, np.int64(stream_id), np.int64(77))
    keys = (lo + (h % np.uint32(hi - lo)).astype(np.int64)).astype(np.int32)
    hw = hashing.hash_combine_np(idx, np.int64(stream_id), np.int64(78))
    weights = (1.0 + hashing.uniform01_np(hw) * 3.0).astype(np.float32)
    return keys, weights


def _tier_cfg(**kw):
    return TierConfig(n_shards=2, checkpoint_every=4, retain_wal=True, fsync=False,
                      backoff_base_s=0.02, call_deadline_s=5.0, **kw)


def _oracle(batches, root):
    """The fault-free in-process tier over the same stream."""
    tier = ShardTier(CFG, _tier_cfg(), root, device="cpu")
    for keys, weights in batches:
        tier.ingest(keys, weights)
    return tier


def _proc_tier(root, *, faults=None, max_restarts=3):
    sup = SupervisorConfig(max_restarts=max_restarts, restart_backoff_s=0.05)
    return ProcShardTier(CFG, _tier_cfg(), root, faults=faults, supervisor=sup, device="cpu")


def _states_equal(proc_tier, oracle):
    for s in range(2):
        got = proc_tier.workers[s].service_view().state_dict()
        want = oracle.workers[s].service.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k].cpu()), (s, k)


def test_sigkill_mid_ingest_recovery_bit_identity(tmp_path):
    batches = [_stream(200, 0, 500, i) for i in range(6)]
    oracle = _oracle(batches, tmp_path / "oracle")
    with _proc_tier(tmp_path / "proc", max_restarts=1) as tier:
        for keys, weights in batches[:3]:
            tier.ingest(keys, weights)
        tier.kill_shard(1)  # a real SIGKILL
        for keys, weights in batches[3:5]:
            tier.ingest(keys, weights)
        tier.check_health()
        for keys, weights in batches[5:]:
            tier.ingest(keys, weights)
        res = tier.query_batch(QUERIES, mode="exact")
        assert res.mode == "exact" and not res.degraded
        st = tier.status()
        s1 = st["shards"][1]
        assert s1["state"] == "up" and s1["alive"]
        assert s1["restarts"] == 1 and isinstance(s1["pid"], int)
        assert s1["applied_seq"] == 6
        assert s1["startup_s"] is not None and s1["startup_s"] > 0
        assert [st["shards"][s]["device"] for s in range(2)] == ["cpu", "cpu"]
        assert any(e[2] == "recovered" for e in st["events"])
        want = oracle.query_batch(QUERIES, mode="exact")
        assert np.array_equal(res.estimates, want.estimates)
        assert np.array_equal(res.variances, want.variances)
        approx = tier.query_batch(QUERIES, mode="approx")
        assert np.array_equal(approx.estimates,
                              oracle.query_batch(QUERIES, mode="approx").estimates)
        _states_equal(tier, oracle)

        # the restart budget is spent: a second kill leaves the slot down
        tier.kill_shard(1)
        tier.check_health()
        assert tier.slots[1] == "down"
        deg = tier.query_batch(QUERIES, mode="auto")
        assert deg.degraded and deg.mode == "approx"
        assert deg.coverage == pytest.approx(tier._routed[0] / sum(tier._routed))
        assert np.all(np.isfinite(deg.estimates))


def test_scheduled_crash_is_a_sigkill_mid_ingest(tmp_path):
    """A ``crash`` event on an ingest site sends the batch and SIGKILLs the
    worker; the tier recovers it and the shard states stay bit-identical."""
    batches = [_stream(180, 0, 400, 50 + i) for i in range(6)]
    oracle = _oracle(batches, tmp_path / "oracle")
    faults = FaultInjector(FaultSchedule(events=(FaultEvent("shard0.ingest", 3, "crash"),)),
                           clock=WallClock())
    with _proc_tier(tmp_path / "proc", faults=faults) as tier:
        pid0 = tier.workers[0].proc.proc.pid
        for keys, weights in batches:
            tier.ingest(keys, weights)
        assert [e.kind for e in faults.fired] == ["crash"]
        assert tier.workers[0].proc.proc.pid != pid0 and tier.slots == ["up", "up"]
        _states_equal(tier, oracle)
        got = tier.query_batch(QUERIES, mode="exact")
        assert np.array_equal(got.estimates,
                              oracle.query_batch(QUERIES, mode="exact").estimates)


def test_chaos_schedule_realized_against_processes(tmp_path):
    sched = FaultSchedule.generate(29, n_shards=2, n_events=10, kinds=PROC_KINDS,
                                   max_call_no=6, max_latency_s=0.05)
    assert sched.events
    faults = FaultInjector(sched, clock=WallClock())
    batches = [_stream(150, 0, 400, 100 + i) for i in range(8)]
    with _proc_tier(tmp_path / "proc", faults=faults, max_restarts=8) as tier:
        for i, (keys, weights) in enumerate(batches):
            tier.ingest(keys, weights)
            if i % 2 == 1:
                tier.check_health()
        for _ in range(20):
            if all(s == "up" for s in tier.slots):
                break
            tier.check_health()
        assert all(s == "up" for s in tier.slots)
        res = tier.query_batch(QUERIES, mode="exact")
        assert {e.kind for e in faults.fired}
    oracle = _oracle(batches, tmp_path / "oracle")
    assert np.array_equal(res.estimates, oracle.query_batch(QUERIES, mode="exact").estimates)


def test_frame_protocol_is_host_numpy():
    a, b = socket.socketpair()
    try:
        svc = StreamStatsService(CFG, device="cpu")
        svc.observe(*_stream(100, 0, 50, 1))
        frame = {"op": "state", "seq": np.int64(3)}
        frame.update(procshard.pack_state(svc.state_dict()))
        procshard.send_frame(a, frame)
        got = procshard.recv_frame(b)
        assert procshard._text(got["op"]) == "state" and int(got["seq"]) == 3
        state = procshard.unpack_state(got)
        assert all(isinstance(v, np.ndarray) for v in state.values())
        back = StreamStatsService(CFG, device="cpu")
        back.load_state_dict(state)
        for k, v in svc.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k
        # a length past the limit is a desync, refused before allocating
        a.sendall(procshard._FRAME_LEN.pack(procshard.MAX_FRAME_BYTES + 1))
        with pytest.raises(ConnectionError, match="desync"):
            procshard.recv_frame(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(ShardDown):
        procshard.raise_remote({"ok": np.bool_(False), "error_type": np.asarray("ShardDown"),
                                "error": np.asarray("gone")})
    with pytest.raises(procshard.RemoteError, match="KeyError"):
        procshard.raise_remote({"error_type": np.asarray("KeyError"), "error": np.asarray("x")})


def test_worker_command_runs_the_port_on_its_device(tmp_path):
    sup = procshard.ShardSupervisor(CFG, tmp_path, _tier_cfg(), device="cuda")
    cmd = sup._worker_cmd(0, "/tmp/s")
    assert cmd[1:3] == ["-m", "repro_torch.launch.shard_worker"]
    assert cmd[cmd.index("--device") + 1] == "cuda"


def test_worker_asked_for_the_card_refuses_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    sup = procshard.ShardSupervisor(CFG, tmp_path, _tier_cfg())
    cmd = sup._worker_cmd(0, str(tmp_path / "s"))
    out = subprocess.run(cmd, env=sup._worker_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcShardTier(CFG, _tier_cfg(), tmp_path / "t")
    assert sys.executable == cmd[0]
