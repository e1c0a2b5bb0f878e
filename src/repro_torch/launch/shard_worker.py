"""Shard worker subprocess entry point (port of ``repro/launch/
shard_worker.py``): ``python -m repro_torch.launch.shard_worker``.

The out-of-process tier (``stats.procshard``) runs each shard as one of
these: a plain event loop around the same in-process
:class:`~..stats.shardtier.ShardWorker` the in-process tier uses --
idempotent seq-deduped apply, checkpoint cadence, WAL-replay recover --
speaking the length-prefixed ``.npz`` frame protocol over an ``AF_UNIX``
socket the supervisor listens on.  ``--device`` (default: the CUDA card)
is resolved by ``core.incremental.resolve_device``: a worker asked for the
card raises without one and never carries on on the CPU.

Protocol (one request frame in, one response frame out, strictly serial):

====================  =====================================================
request ``op``        response (on ``ok=True``)
====================  =====================================================
``apply``             ``applied_seq``, ``last_ckpt_seq`` (idempotent ack)
``heartbeat``         ``applied_seq``, ``last_ckpt_seq``
``checkpoint``        ``applied_seq``, ``last_ckpt_seq``
``recover``           ``applied_seq``, ``last_ckpt_seq``
``state``             flat ``state_dict`` leaves (host numpy) under ``s_``
``shutdown``          (ack, then the process exits 0)
====================  =====================================================

The hello frame on each connect carries the shard id, the pid, the device
of the shard's service and the wall time at which the worker became ready
(its service built on that device).
Failures reply ``ok=False`` with ``error_type``/``error``; the client maps
``ShardDown``/``ValueError`` back onto themselves and wraps everything else
in ``RemoteError``.  An EOF on the socket means the coordinator dropped the
connection (shutdown or an injected partition) -- the worker reconnects to
the same socket path and keeps its state: a partition must not look like a
crash.  The worker only exits on an explicit ``shutdown`` op or when the
socket path stops accepting connections (coordinator gone for good).

Durable state -- checkpoints and the WAL -- lives under ``--root`` on a
filesystem shared with the coordinator: the coordinator appends WAL
segments (WAL-first ingest) and runs exact pass II from them; this process
restores/replays them in ``recover`` and truncates them at checkpoints
(unless ``--retain-wal``).
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import time


def _build_worker(args):
    # the torch import happens here (inside repro_torch.stats): keep the
    # cold-start cost out of module import so ``--help`` stays instant
    from ..stats.service import StatsConfig
    from ..stats.shardtier import ShardWorker
    import json

    cfg_d = json.loads(args.config_json)
    cfg_d["ls"] = tuple(cfg_d["ls"])
    config = StatsConfig(**cfg_d)
    return ShardWorker(
        args.shard_id, config, args.root,
        checkpoint_every=args.checkpoint_every,
        retain_wal=bool(args.retain_wal),
        fsync=bool(args.fsync), device=args.device)


def _serve_conn(conn: socket.socket, worker, ready_wall: float) -> bool:
    """Serve one connection until EOF (returns True: reconnect) or a
    shutdown op (returns False: exit)."""
    import numpy as np

    from ..stats.procshard import pack_state, recv_frame, send_frame, _text

    send_frame(conn, {"op": "hello", "shard_id": np.int64(worker.shard_id),
                      "pid": np.int64(os.getpid()), "device": str(worker.device),
                      "ready_wall": np.float64(ready_wall)})
    while True:
        try:
            req = recv_frame(conn)
        except (ConnectionError, OSError):
            return True  # coordinator dropped us; keep state, reconnect
        op = _text(req["op"])
        try:
            if op == "shutdown":
                send_frame(conn, {"ok": True})
                return False
            if op == "apply":
                worker.apply(int(req["seq"]), req["keys"], req["weights"])
            elif op == "heartbeat":
                worker.heartbeat()
            elif op == "checkpoint":
                worker.checkpoint()
            elif op == "recover":
                worker.recover()
            elif op == "state":
                svc = worker.service_view()
                resp = {"ok": True,
                        "applied_seq": np.int64(worker.applied_seq)}
                resp.update(pack_state(svc.state_dict()))
                send_frame(conn, resp)
                continue
            else:
                raise ValueError(f"unknown op {op!r}")
            send_frame(conn, {
                "ok": True,
                "applied_seq": np.int64(worker.applied_seq),
                "last_ckpt_seq": np.int64(worker._last_ckpt_seq),
            })
        except Exception as e:  # noqa: BLE001 — every failure goes on the wire
            try:
                send_frame(conn, {"ok": False,
                                  "error_type": type(e).__name__,
                                  "error": str(e)})
            except (ConnectionError, OSError):
                return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--socket", required=True,
                    help="AF_UNIX path the supervisor listens on")
    ap.add_argument("--shard-id", type=int, required=True)
    ap.add_argument("--root", required=True,
                    help="tier root (shared fs: checkpoints + WAL)")
    ap.add_argument("--config-json", required=True,
                    help="StatsConfig fields as JSON (host_id unset)")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--retain-wal", type=int, default=0)
    ap.add_argument("--fsync", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device of the shard's service (default: the "
                         "CUDA card; raises without one)")
    ap.add_argument("--reconnect-window-s", type=float, default=10.0,
                    help="keep retrying connect this long after an EOF "
                         "before concluding the coordinator is gone")
    args = ap.parse_args(argv)

    worker = _build_worker(args)
    ready_wall = time.time()
    first = True
    while True:
        deadline = time.monotonic() + args.reconnect_window_s
        conn = None
        while True:
            try:
                conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                conn.connect(args.socket)
                break
            except OSError:
                conn.close()
                conn = None
                if first or time.monotonic() >= deadline:
                    # never managed a first connect, or the listener is
                    # gone past the window: nothing left to serve
                    return 1
                time.sleep(0.05)
        first = False
        try:
            if not _serve_conn(conn, worker, ready_wall):
                return 0
        finally:
            conn.close()


if __name__ == "__main__":
    sys.exit(main())
