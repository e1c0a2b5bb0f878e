"""Deterministic fault injection for the sharded ingestion tier (port of
``repro/launch/faults.py``; host Python, no tensors).

Every failure path of ``stats.shardtier`` is exercised by *replayable*
schedules, not by ambient randomness: a :class:`FaultSchedule` is a frozen
list of ``(site, call_no, kind, param)`` events derived from a seed through
the same counter-based hashing that drives the samplers
(``core.hashing.hash_combine_np``, bit for bit the reference's, so one seed
gives the same events in both packages).  The tier wraps every
failure-prone operation in a context-managed hook::

    with injector.site("shard2.ingest"):
        worker.apply(seq, keys, weights)

and the injector fires an event when that site's invocation counter matches
an event's ``call_no``.  The same schedules drive two backends: the
in-process tier (``stats.shardtier``) receives faults as exceptions from
``site()``, and the out-of-process tier (``stats.procshard``) consumes
events through ``poll()`` and realizes them against real worker
subprocesses: ``crash`` becomes a ``SIGKILL``, ``partition`` severs the
socket.  The fault kinds:

* ``crash``      -- the callee dies before doing any work (the worker drops
  its in-memory state; recovery = checkpoint restore + WAL replay);
* ``stall``      -- the call times out (the clock advances past the
  deadline, the operation never ran; the caller's bounded retry fires);
* ``slow``       -- the call succeeds but late (the clock advances);
* ``lost_reply`` -- the operation ran but the reply is dropped (retries
  must be idempotent: the tier dedups by WAL sequence number);
* ``partition``  -- process mode only (``PROC_KINDS``): the connection to a
  live worker drops and is re-established.

Schedules serialize to and from plain JSON (``to_json``/``from_json``), so
a failing seed can be committed verbatim as a regression schedule.  Time is
virtual by default (:class:`VirtualClock`): backoff sleeps and stall/slow
latencies advance a counter, so a chaos run is fast and bit-deterministic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import numpy as np

from ..core import hashing

# The injection-site registry: format strings over the shard id.  Keep
# this list in sync with stats/shardtier.py -- the chaos tests generate
# schedules over exactly these sites.
SITES = (
    "shard{i}.ingest",      # ShardWorker.apply (WAL already durable)
    "shard{i}.heartbeat",   # ShardWorker.heartbeat (failure detection)
    "shard{i}.query",       # ShardWorker.sampler_view (snapshot extraction)
    "shard{i}.checkpoint",  # ShardWorker.checkpoint (atomic commit inside)
    "shard{i}.recover",     # ShardWorker.recover (restore + WAL replay)
)

KINDS = ("crash", "stall", "slow", "lost_reply")

# Process-mode schedules (stats.procshard) additionally draw ``partition``:
# the coordinator's connection to a live worker drops — the process keeps
# running and keeps its state, but every call fails until a reconnect.
# Kept OUT of KINDS so existing seeds map to the same schedules they always
# did (generate() indexes kinds by hash % len(kinds)).
PROC_KINDS = KINDS + ("partition",)


class FaultError(RuntimeError):
    """Base of all injected faults; carries the site it fired at."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}" + (f": {detail}" if detail else ""))
        self.site = site


class InjectedCrash(FaultError):
    """The callee process died — its in-memory state is gone."""


class InjectedStall(FaultError):
    """The call exceeded its deadline; the operation did NOT run."""


class InjectedLostReply(FaultError):
    """The operation ran but the reply was dropped on the wire."""


class InjectedPartition(FaultError):
    """The network path to a LIVE callee dropped: the operation did not run
    (process-mode backends sever the real connection; callers must treat it
    like a stall — retriable — and reconnect)."""


class Unreachable(RuntimeError):
    """A real transport failure (socket timeout, refused connect) to a
    worker whose process may still be alive.  NOT an injected fault — this
    is what genuine process-mode flakiness surfaces as.  Callers retry it
    exactly like a stall; only process death maps to ShardDown."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire ``kind`` on the ``call_no``-th invocation
    (1-based) of ``site``.  ``param`` is the stall/slow latency in (virtual)
    seconds; ignored for crash/lost_reply."""

    site: str
    call_no: int
    kind: str
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in PROC_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {PROC_KINDS})")
        if self.call_no < 1:
            raise ValueError("call_no is 1-based")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A frozen, replayable set of fault events."""

    events: tuple[FaultEvent, ...] = ()
    seed: int | None = None  # provenance only; replay uses the events

    @classmethod
    def generate(cls, seed: int, *, n_shards: int, n_events: int,
                 sites: tuple[str, ...] = SITES,
                 kinds: tuple[str, ...] = KINDS,
                 max_call_no: int = 8,
                 max_latency_s: float = 2.0) -> "FaultSchedule":
        """Derive ``n_events`` events from ``seed`` with counter-based
        hashing (bit-reproducible across platforms; no PRNG state).

        Events are deduplicated on (site, call_no) — two faults cannot fire
        on the same invocation — so the realized count can be < n_events.
        """
        idx = np.arange(n_events, dtype=np.int64)
        # idx first: the array part keeps the uint32 mixing array-shaped
        # (0-d chains trip numpy's scalar-overflow warning)
        h_site = hashing.hash_combine_np(idx, np.int64(seed), np.int64(0))
        h_shard = hashing.hash_combine_np(idx, np.int64(seed), np.int64(1))
        h_call = hashing.hash_combine_np(idx, np.int64(seed), np.int64(2))
        h_kind = hashing.hash_combine_np(idx, np.int64(seed), np.int64(3))
        h_lat = hashing.hash_combine_np(idx, np.int64(seed), np.int64(4))
        events: dict[tuple[str, int], FaultEvent] = {}
        for i in range(n_events):
            site = sites[int(h_site[i]) % len(sites)].format(
                i=int(h_shard[i]) % n_shards)
            call_no = 1 + int(h_call[i]) % max_call_no
            kind = kinds[int(h_kind[i]) % len(kinds)]
            lat = float(hashing.uniform01_np(h_lat[i])) * max_latency_s
            events.setdefault((site, call_no), FaultEvent(
                site=site, call_no=call_no, kind=kind,
                param=round(lat, 6) if kind in ("stall", "slow") else 0.0))
        ordered = tuple(sorted(events.values(),
                               key=lambda e: (e.site, e.call_no)))
        return cls(events=ordered, seed=seed)

    # -- record/replay -----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events],
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        d = json.loads(text)
        return cls(events=tuple(FaultEvent(**e) for e in d["events"]),
                   seed=d.get("seed"))


class VirtualClock:
    """Deterministic time for the chaos suite: ``sleep``/``advance`` move a
    counter, never the wall clock — a seeded run is bit-reproducible and
    takes no real time regardless of how many backoffs it schedules."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self._t += max(float(dt), 0.0)

    advance = sleep


class WallClock:
    """Real time, for live deployments of the tier."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        time.sleep(max(float(dt), 0.0))

    def advance(self, dt: float) -> None:
        """Injected latency under a wall clock is simulated by sleeping."""
        self.sleep(dt)


class FaultInjector:
    """Fires a schedule's events at named call sites (context-managed).

    Per-site invocation counters make injection deterministic: the Nth
    ``with injector.site(s):`` block fires the event scheduled for
    ``(s, N)`` regardless of wall time or interleaving elsewhere.  The
    injector records every fired event in ``fired`` (a replayable trace).
    """

    def __init__(self, schedule: FaultSchedule | None = None,
                 clock: VirtualClock | WallClock | None = None):
        self.schedule = schedule or FaultSchedule()
        self.clock = clock if clock is not None else VirtualClock()
        self._by_key = {(e.site, e.call_no): e for e in self.schedule.events}
        self.counts: dict[str, int] = {}
        self.fired: list[FaultEvent] = []

    def _next(self, site: str) -> FaultEvent | None:
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        return self._by_key.get((site, n))

    def poll(self, site: str) -> FaultEvent | None:
        """Advance ``site``'s invocation counter and return the event
        scheduled for this call (recording it in ``fired``), or None.

        This is the raw hook for backends that must ACT on an event rather
        than receive it as an exception — the process-mode backend
        (stats.procshard) turns ``crash`` into a real SIGKILL and
        ``partition`` into severing a real socket, which no in-process
        raise can express."""
        ev = self._next(site)
        if ev is not None:
            self.fired.append(ev)
        return ev

    @contextlib.contextmanager
    def site(self, name: str):
        """Wrap one failure-prone operation.  May raise InjectedCrash /
        InjectedStall / InjectedPartition *instead of* running the body,
        advance the clock and run it (slow), or run it and then raise
        InjectedLostReply."""
        ev = self.poll(name)
        if ev is not None:
            if ev.kind == "crash":
                raise InjectedCrash(name)
            if ev.kind == "stall":
                self.clock.advance(ev.param)
                raise InjectedStall(name, f"stalled {ev.param:g}s")
            if ev.kind == "partition":
                raise InjectedPartition(name)
            if ev.kind == "slow":
                self.clock.advance(ev.param)
        yield
        if ev is not None and ev.kind == "lost_reply":
            raise InjectedLostReply(name)
