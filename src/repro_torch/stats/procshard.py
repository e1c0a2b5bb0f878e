"""Out-of-process shard tier (port of ``repro/stats/procshard.py``): real
worker subprocesses behind the ``ShardTier`` coordinator.

``stats.shardtier`` holds the recovery contract -- WAL-first ingest,
checkpoint + replay recovery bit-identical to the never-crashed run --
against injected exceptions.  This module runs the same contract against
real process death: each shard worker is an OS subprocess
(``python -m repro_torch.launch.shard_worker``) speaking a length-prefixed
``.npz`` frame protocol over an ``AF_UNIX`` socket, and the chaos schedule's
events are realized rather than raised: ``crash`` is a ``SIGKILL`` racing
an in-flight apply, ``partition`` severs the connection.  Each worker
holds its shard's service on ``device`` (the CUDA card unless the caller
asks for the CPU): on a card every worker process opens a CUDA context of
its own.

Layers:

* **Frame protocol** (``send_frame`` / ``recv_frame``) -- 8-byte big-endian
  length prefix + one ``np.savez`` archive (``allow_pickle=False`` both
  ways).  Everything on the wire is host numpy: ops and error strings ride
  as 0-d unicode arrays, service state rides as the flat ``state_dict``
  leaves (copied off the device by ``pack_state``) under an ``s_`` prefix.

* **ShardProcess** -- one worker subprocess + its socket: the supervisor
  binds and listens before ``Popen`` (the worker connects; a severed worker
  reconnects to the same listener), reads a hello frame on accept, and
  classifies transport failures: timeout/EOF with the process alive is
  ``Unreachable`` (retriable, exactly like a stall), with the process dead
  it is ``ShardDown``.

* **ShardSupervisor** -- owns every ShardProcess: parallel spawn (all
  workers pay the interpreter, torch import and CUDA context at once),
  bounded restart with backoff (``max_restarts`` per shard), shutdown.

* **ProcWorkerClient** -- the ShardWorker surface (apply / heartbeat /
  checkpoint / recover / service_view) as RPCs, with the fault schedule
  realized against the real process through ``FaultInjector.poll``.  It
  keeps the coordinator-side ``ShardWAL`` (a filesystem shared with the
  worker), so WAL-first ingest, torn-tail repair and exact pass II run
  coordinator-side without shipping segments over the socket.

* **ProcShardTier** -- ``ShardTier`` with ``_make_worker`` swapped for
  ProcWorkerClient and a wall clock; routing, health accounting, the
  degraded/exact/snapshot queries, the merge cadence and the status plane
  are inherited unchanged.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..core.incremental import resolve_device
from ..launch.faults import (
    FaultInjector,
    InjectedLostReply,
    InjectedPartition,
    InjectedStall,
    Unreachable,
    WallClock,
)
from .service import StatsConfig, StreamStatsService
from .shardtier import ShardDown, ShardTier, ShardWAL, TierConfig


# ---------------------------------------------------------------------------
# Frame protocol
# ---------------------------------------------------------------------------

_FRAME_LEN = struct.Struct(">Q")
# npz state for k=4096 x 8 lanes is ~1 MiB; a frame far beyond any real
# payload indicates a desynced/corrupt stream — fail fast, don't allocate.
MAX_FRAME_BYTES = 1 << 30


def send_frame(sock: socket.socket, arrays: dict) -> None:
    """Write one frame: 8-byte big-endian payload length + npz archive.
    Values must be numpy arrays/scalars (strings are passed through
    ``np.asarray`` — 0-d unicode arrays round-trip)."""
    buf = io.BytesIO()
    np.savez(buf, allow_pickle=False,
             **{k: np.asarray(v) for k, v in arrays.items()})
    payload = buf.getvalue()
    sock.sendall(_FRAME_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> dict:
    """Read one frame; raises ConnectionError on EOF, socket.timeout on a
    configured timeout."""
    (n,) = _FRAME_LEN.unpack(_recv_exact(sock, _FRAME_LEN.size))
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {n} exceeds {MAX_FRAME_BYTES} "
                              "— protocol desync")
    payload = _recv_exact(sock, n)
    with np.load(io.BytesIO(payload), allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _text(v) -> str:
    """Unwrap a 0-d unicode array back to str."""
    return str(np.asarray(v).item())


# -- request/response helpers (shared with launch.shard_worker) -------------

_STATE_PREFIX = "s_"  # state_dict leaves on the wire (avoids op/seq collision)


def pack_state(d: dict) -> dict:
    """State-dict leaves as host numpy arrays under the wire prefix."""
    return {_STATE_PREFIX + k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                else np.asarray(v))
            for k, v in d.items()}


def unpack_state(frame: dict) -> dict:
    return {k[len(_STATE_PREFIX):]: v for k, v in frame.items()
            if k.startswith(_STATE_PREFIX)}


class RemoteError(RuntimeError):
    """The worker raised something other than ShardDown/ValueError; carries
    the remote type name + message."""


def raise_remote(frame: dict) -> None:
    """Re-raise a worker-side failure response coordinator-side, mapping the
    two protocol-meaningful types back to themselves."""
    etype = _text(frame.get("error_type", "RuntimeError"))
    msg = _text(frame.get("error", ""))
    if etype == "ShardDown":
        raise ShardDown(msg)
    if etype == "ValueError":
        raise ValueError(msg)
    raise RemoteError(f"{etype}: {msg}")


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupervisorConfig:
    """Process-mode knobs.  All times are WALL seconds — process mode has no
    virtual clock (real processes fail on real time)."""

    # per-RPC reply deadline (apply/heartbeat/checkpoint/state)
    call_timeout_s: float = 30.0
    # worker startup budget: interpreter + torch import + CUDA context +
    # first connect
    connect_timeout_s: float = 120.0
    # recover() replays the WAL tail inside one RPC — allow longer
    recover_timeout_s: float = 120.0
    # bounded restart-with-backoff: respawn attempts per shard beyond the
    # first spawn; exhausted -> the slot stays down (ShardDown)
    max_restarts: int = 3
    restart_backoff_s: float = 0.2
    restart_backoff_factor: float = 2.0


class ShardProcess:
    """One worker subprocess + its connection.

    The supervisor side owns the listening socket for this shard (bound
    before the first spawn, reused across restarts and partitions — the
    worker end always connects/reconnects to the same path).  Socket paths
    live in a private short tmpdir, NOT under the tier root: ``AF_UNIX``
    paths are capped around 100 bytes and test tmp roots routinely blow
    past that."""

    def __init__(self, shard_id: int, cmd: list[str],
                 cfg: SupervisorConfig, env: dict | None = None):
        self.shard_id = int(shard_id)
        self.cmd = list(cmd)
        self.cfg = cfg
        self.env = env
        self._sockdir = tempfile.mkdtemp(prefix=f"procshard{shard_id}_")
        self.sock_path = os.path.join(self._sockdir, "s")
        self._listener: socket.socket | None = None
        self.proc: subprocess.Popen | None = None
        self.conn: socket.socket | None = None
        self.restarts = 0
        self.spawned_at: float | None = None
        self._spawned_wall: float | None = None
        # wall seconds from Popen to the worker's hello (interpreter, torch
        # import, the service on its device), of the latest spawn, and the
        # device the worker reported
        self.startup_s: float | None = None
        self.worker_device: str | None = None

    # -- lifecycle ---------------------------------------------------------

    def _ensure_listener(self) -> None:
        if self._listener is not None:
            return
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(self.sock_path)
        lst.listen(2)
        self._listener = lst

    def spawn(self, cmd_extra: list[str] = ()) -> None:
        """Bind+listen first, then Popen — the worker's connect cannot race
        the listener into ECONNREFUSED.  Does NOT wait for the hello: all
        shards spawn back-to-back and pay the import cost concurrently; the
        first RPC blocks on accept."""
        self._ensure_listener()
        self.proc = subprocess.Popen(
            self.cmd + list(cmd_extra),
            stdin=subprocess.DEVNULL,
            env=self.env,
            start_new_session=True,  # coordinator ^C must not kill workers
        )
        self.spawned_at = time.monotonic()
        self._spawned_wall = time.time()
        self.startup_s = None

    def proc_alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _accept(self, timeout: float) -> None:
        self._ensure_listener()
        self._listener.settimeout(timeout)
        try:
            conn, _ = self._listener.accept()
        except socket.timeout:
            if not self.proc_alive():
                raise ShardDown(
                    f"shard {self.shard_id}: worker process died before "
                    "connecting") from None
            raise Unreachable(
                f"shard {self.shard_id}: no connection within {timeout}s "
                "(process alive)") from None
        conn.settimeout(self.cfg.call_timeout_s)
        hello = recv_frame(conn)
        if _text(hello.get("op", "")) != "hello":
            conn.close()
            raise ConnectionError(
                f"shard {self.shard_id}: bad handshake {hello.keys()}")
        if self.startup_s is None and "ready_wall" in hello:
            self.startup_s = float(hello["ready_wall"]) - self._spawned_wall
        if "device" in hello:
            self.worker_device = _text(hello["device"])
        self.conn = conn

    def ensure_conn(self, timeout: float | None = None) -> socket.socket:
        if self.conn is None:
            if not self.proc_alive():
                raise ShardDown(f"shard {self.shard_id}: process is dead")
            # the full startup budget covers both a fresh spawn (interpreter
            # + torch import) and a near-instant reconnect after a partition
            self._accept(self.cfg.connect_timeout_s
                         if timeout is None else timeout)
        return self.conn

    def sever(self) -> None:
        """Partition realization: drop the accepted connection.  The worker
        sees EOF and reconnects to the (still listening) socket path; the
        next RPC re-accepts."""
        if self.conn is not None:
            try:
                self.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.conn.close()
            self.conn = None

    def kill(self) -> None:
        """SIGKILL — the real thing.  Durable state (checkpoints + WAL on
        the shared filesystem) is all that survives."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.sever()

    def restart(self) -> None:
        """Bounded respawn with exponential backoff.  Raises ShardDown once
        the restart budget is exhausted — the slot stays down and queries
        degrade rather than the tier retrying forever."""
        if self.restarts >= self.cfg.max_restarts:
            raise ShardDown(
                f"shard {self.shard_id}: restart budget exhausted "
                f"({self.restarts}/{self.cfg.max_restarts})")
        delay = (self.cfg.restart_backoff_s
                 * self.cfg.restart_backoff_factor ** self.restarts)
        self.restarts += 1
        time.sleep(delay)
        self.kill()
        self.spawn()

    def shutdown(self, grace_s: float = 5.0) -> None:
        """Graceful stop: shutdown RPC, wait, escalate to SIGKILL."""
        if self.proc_alive() and self.conn is not None:
            try:
                self.conn.settimeout(grace_s)
                send_frame(self.conn, {"op": "shutdown"})
                recv_frame(self.conn)
            except (OSError, ConnectionError, socket.timeout):
                pass
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.sever()

    def close(self) -> None:
        self.shutdown()
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        shutil.rmtree(self._sockdir, ignore_errors=True)

    # -- one RPC -----------------------------------------------------------

    def rpc(self, req: dict, *, timeout: float | None = None) -> dict:
        """Send one request frame, read one response frame.  Transport
        failures are classified by process liveness: dead -> ShardDown,
        alive -> Unreachable (the coordinator's bounded retry handles it
        exactly like a stall; the connection is dropped so the retry
        re-accepts a clean stream)."""
        t = self.cfg.call_timeout_s if timeout is None else timeout
        try:
            conn = self.ensure_conn()
            conn.settimeout(t)
            send_frame(conn, req)
            resp = recv_frame(conn)
        except ShardDown:
            raise
        except socket.timeout:
            self.sever()  # a late reply would desync the next RPC
            if not self.proc_alive():
                raise ShardDown(
                    f"shard {self.shard_id}: process died mid-call") from None
            raise Unreachable(
                f"shard {self.shard_id}: no reply within {t}s") from None
        except (ConnectionError, OSError) as e:
            self.sever()
            if not self.proc_alive():
                raise ShardDown(
                    f"shard {self.shard_id}: process is dead ({e})") from None
            raise Unreachable(f"shard {self.shard_id}: {e}") from None
        if not bool(resp.get("ok", False)):
            raise_remote(resp)
        return resp


class ShardSupervisor:
    """Spawns and owns the worker subprocesses for one tier.

    Besides lifecycle (parallel spawn, restart budgets, graceful shutdown)
    it answers the liveness question the coordinator's retry logic needs —
    ``proc_alive(s)`` — and realizes the physical halves of the chaos
    vocabulary (``kill``/``sever``) that in-process injection could only
    name."""

    def __init__(self, base_config: StatsConfig, root, tier: TierConfig,
                 cfg: SupervisorConfig | None = None, *, device="cuda"):
        self.cfg = cfg or SupervisorConfig()
        self.device = str(device)
        self.root = Path(root)
        self.tier = tier
        self.base_config = base_config
        self.procs: dict[int, ShardProcess] = {}

    def _worker_cmd(self, s: int, sock_path: str) -> list[str]:
        cfg_json = json.dumps(dataclasses.asdict(
            dataclasses.replace(self.base_config, ls=list(self.base_config.ls))))
        return [
            sys.executable, "-m", "repro_torch.launch.shard_worker",
            "--socket", sock_path,
            "--shard-id", str(s),
            "--root", str(self.root),
            "--config-json", cfg_json,
            "--checkpoint-every", str(self.tier.checkpoint_every),
            "--retain-wal", str(int(self.tier.retain_wal)),
            "--fsync", str(int(self.tier.fsync)),
            "--device", self.device,
        ]

    def _worker_env(self) -> dict:
        """The child must import ``repro_torch`` no matter how the coordinator
        was launched: prepend this package's source root to PYTHONPATH."""
        src_root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        pp = env.get("PYTHONPATH", "")
        if src_root not in pp.split(os.pathsep):
            env["PYTHONPATH"] = (src_root + os.pathsep + pp) if pp else src_root
        return env

    def get(self, s: int) -> ShardProcess:
        sp = self.procs.get(s)
        if sp is None:
            sp = ShardProcess(s, [], self.cfg, env=self._worker_env())
            sp.cmd = self._worker_cmd(s, sp.sock_path)
            self.procs[s] = sp
            sp.spawn()
        return sp

    def close(self) -> None:
        for sp in self.procs.values():
            sp.close()
        self.procs.clear()


# ---------------------------------------------------------------------------
# Worker client (the ShardWorker surface over the wire)
# ---------------------------------------------------------------------------


class ProcWorkerClient:
    """ShardWorker-shaped client over one worker subprocess.

    ShardTier drives this exactly like the in-process worker: same method
    surface, same exception vocabulary (ShardDown terminal, Unreachable/
    Injected* retriable), same WAL attribute (coordinator-side instance on
    the shared filesystem — WAL-first ingest and exact pass II never touch
    the socket).  The fault schedule is realized here, against the real
    process, through ``FaultInjector.poll``."""

    def __init__(self, shard_id: int, base_config: StatsConfig,
                 supervisor: ShardSupervisor, *,
                 faults: FaultInjector, fsync: bool = True, device=None):
        self.shard_id = int(shard_id)
        self.device = resolve_device(device)
        self.base_config = base_config
        self.sup = supervisor
        self._faults = faults
        self.root = supervisor.root / f"shard_{self.shard_id:02d}"
        self.wal = ShardWAL(self.root / "wal", fsync=fsync)
        self.applied_seq = 0      # coordinator mirror (refreshed by acks)
        self._last_ckpt_seq = 0   # best-effort mirror (worker owns cadence)
        self.proc = supervisor.get(shard_id)

    # -- surface bookkeeping ----------------------------------------------

    @property
    def alive(self) -> bool:
        return self.proc.proc_alive()

    def _site(self, op: str) -> str:
        return f"shard{self.shard_id}.{op}"

    def crash(self) -> None:
        """The tier's kill hook — in process mode this is a real SIGKILL."""
        self.proc.kill()

    # -- fault-realized RPC ------------------------------------------------

    def _guarded_rpc(self, op: str, req: dict, *,
                     timeout: float | None = None) -> dict:
        """One RPC behind the shard's injection site, realized physically:

        crash      -> SEND the request, then SIGKILL.  The worker may or may
                      not have applied before dying — a genuine mid-ingest
                      race; recovery is bit-identical either way (the WAL
                      segment was durable before this call and ``recover``
                      rebuilds from durable state alone).
        stall      -> never send; sleep the latency; raise (retriable).
        partition  -> sever the live connection; raise (retriable; the
                      retry's RPC re-accepts the worker's reconnect).
        slow       -> sleep the latency, then proceed normally.
        lost_reply -> full RPC (the op RAN remotely), discard the reply.
        """
        site = self._site(op)
        ev = self._faults.poll(site)
        clock = self._faults.clock
        if ev is not None:
            if ev.kind == "crash":
                try:
                    conn = self.proc.ensure_conn()
                    send_frame(conn, req)
                except (ShardDown, Unreachable, ConnectionError, OSError):
                    pass  # the kill is the point; delivery is best-effort
                self.proc.kill()
                raise ShardDown(
                    f"shard {self.shard_id} SIGKILLed in {op}")
            if ev.kind == "stall":
                clock.advance(ev.param)
                raise InjectedStall(site, f"stalled {ev.param:g}s")
            if ev.kind == "partition":
                self.proc.sever()
                raise InjectedPartition(site)
            if ev.kind == "slow":
                clock.advance(ev.param)
        resp = self.proc.rpc(req, timeout=timeout)
        if ev is not None and ev.kind == "lost_reply":
            raise InjectedLostReply(site)
        return resp

    # -- ShardWorker surface ----------------------------------------------

    def heartbeat(self) -> int:
        resp = self._guarded_rpc("heartbeat", {"op": "heartbeat"})
        self.applied_seq = int(resp["applied_seq"])
        self._last_ckpt_seq = int(resp["last_ckpt_seq"])
        return self.applied_seq

    def apply(self, seq: int, keys, weights) -> int:
        resp = self._guarded_rpc("ingest", {
            "op": "apply", "seq": np.int64(seq),
            "keys": np.asarray(keys, np.int32),
            "weights": np.asarray(weights, np.float32),
        })
        self.applied_seq = int(resp["applied_seq"])
        self._last_ckpt_seq = int(resp["last_ckpt_seq"])
        return self.applied_seq

    def checkpoint(self) -> int:
        resp = self._guarded_rpc("checkpoint", {"op": "checkpoint"})
        self.applied_seq = int(resp["applied_seq"])
        self._last_ckpt_seq = self.applied_seq
        return self.applied_seq

    def service_view(self) -> StreamStatsService:
        """Fetch the worker's state_dict over the wire and rebuild a local
        service on the coordinator's device -- state_dict round-trips bit
        for bit, so the local rebuild IS the worker's sketch."""
        resp = self._guarded_rpc("state", {"op": "state"})
        svc = StreamStatsService(dataclasses.replace(
            self.base_config, host_id=self.shard_id), device=self.device)
        svc.load_state_dict(unpack_state(resp))
        return svc

    def recover(self) -> int:
        """Process-mode recovery: repair/drop a torn WAL tail coordinator-
        side first (the WAL-first buffer lives HERE, not in the worker),
        respawn the process if it is dead (bounded restart-with-backoff),
        then one recover RPC — the worker restores its latest checkpoint
        and replays the WAL tail, both from the shared filesystem."""
        self.wal.check_tail()
        if not self.proc.proc_alive():
            self.proc.restart()  # raises ShardDown past the budget
        resp = self._guarded_rpc(
            "recover", {"op": "recover"},
            timeout=self.sup.cfg.recover_timeout_s)
        self.applied_seq = int(resp["applied_seq"])
        self._last_ckpt_seq = int(resp["last_ckpt_seq"])
        return self.applied_seq

    def runtime_status(self) -> dict:
        return {
            "alive": self.alive,
            "applied_seq": self.applied_seq,
            "last_checkpoint_seq": self._last_ckpt_seq,
            "wal_depth": len(self.wal.seqs()),
            "pid": None if self.proc.proc is None else self.proc.proc.pid,
            "restarts": self.proc.restarts,
            "startup_s": self.proc.startup_s,
            "device": self.proc.worker_device,
        }


# ---------------------------------------------------------------------------
# The tier
# ---------------------------------------------------------------------------


class ProcShardTier(ShardTier):
    """ShardTier over real worker subprocesses.

    Differences from the in-process tier are confined to the worker factory
    and the clock: time is WALL time (heartbeat deadlines, retry backoff and
    injected stall/slow latencies really elapse), and the chaos schedule is
    realized physically by ProcWorkerClient.  ``device`` is both the
    workers' (passed on their command line; each resolves it and raises
    without a card rather than carry on on the CPU) and the coordinator's,
    where the query folds run.  Use as a context manager (or call
    ``close()``) -- worker processes outlive an abandoned coordinator
    otherwise.
    """

    def __init__(self, config: StatsConfig, tier: TierConfig | None = None,
                 root=None, *, faults: FaultInjector | None = None,
                 supervisor: SupervisorConfig | None = None, device=None):
        if faults is None:
            faults = FaultInjector(clock=WallClock())
        if isinstance(faults.clock, WallClock) is False:
            raise ValueError(
                "ProcShardTier runs on wall time; construct the injector "
                "with clock=WallClock()")
        dev = resolve_device(device)
        self.sup = ShardSupervisor(config, Path(root), tier or TierConfig(),
                                   supervisor, device=dev)
        super().__init__(config, tier, root, faults=faults, device=dev)

    def _make_worker(self, s: int):
        return ProcWorkerClient(s, self.base_config, self.sup,
                                faults=self._faults, fsync=self.tier.fsync,
                                device=self.device)

    def close(self) -> None:
        self.sup.close()

    def __enter__(self) -> "ProcShardTier":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
