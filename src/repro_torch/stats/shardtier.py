"""Fault-tolerant sharded ingestion tier (port of ``repro/stats/
shardtier.py``): key-routed shards, WAL + checkpoint recovery, heartbeat
failure detection, degraded-mode queries.

Host orchestration over the ported ``StreamStatsService``: numpy on disk
and on the routing path, torch on ``device`` inside each shard (the CUDA
card unless the caller asks for the CPU, as the tests do).

The paper's sketches are mergeable, and key-partitioned shards make even
the cheap one-pass merge unbiased, so a router that hashes keys to shards
can lose and recover shards without compromising correctness, provided
recovery is disciplined.  Because all sampling randomness hangs off salted
(key, eid) hashes (``core.hashing``; no generator state), replaying a
shard's stream after a crash reproduces bit-identical sketch state:

* ``route_keys`` / ``partition_batch`` -- ``hash(key) % n_shards`` through
  the samplers' counter-based hashing (own salt), deterministic and stable
  across restarts, bit for bit the reference's partition;
* ``ShardWAL`` -- a per-shard write-ahead log of routed batches, one
  fsynced ``.npz`` segment with a CRC32 trailer per sequence number (write,
  fsync the file, rename, fsync the directory, through
  ``checkpoint.manager``), truncated at each checkpoint unless
  ``retain_wal`` keeps the full stream for exact pass II.  Its segments are
  byte-compatible with the reference's, so either package replays the
  other's log;
* ``ShardWorker`` -- one in-process shard: a ``StreamStatsService`` with
  ``host_id = shard_id``, an idempotent sequence-deduped ``apply``, a
  checkpoint cadence, and ``recover()`` = checkpoint restore + WAL replay,
  bit-identical to the never-crashed worker;
* ``ShardTier`` -- the coordinator: WAL-first ingest, heartbeats with a
  miss limit, bounded retry with exponential backoff and a deadline on the
  tier's clock, restarts through ``recover()``, and queries in the modes
  ``approx`` (fold the surviving shards' sketches), ``exact`` (exact merge
  of the lossless summaries, then pass II over every shard's complete WAL
  through ``reconcile``, whose sums run through the deterministic fold
  kernel on a card), ``auto`` (exact when available, else degraded approx)
  and ``snapshot`` (the background exact merge).  Answers from a partial
  tier carry a coverage/staleness stamp on ``BatchResult`` and are scaled
  by the shard-inclusion Horvitz-Thompson factor 1/coverage.

Failure injection rides ``launch.faults``: every failure-prone operation is
wrapped in ``injector.site("shard{i}.<op>")``, so seeded schedules (crash,
stall, slow, lost reply) exercise every path.
"""
from __future__ import annotations

import dataclasses
import io
import logging
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from ..checkpoint import manager as ckpt_manager
from ..core import hashing
from ..core.incremental import resolve_device
from ..core.segments import normalize_keys
from ..launch.faults import (
    FaultInjector,
    InjectedCrash,
    InjectedLostReply,
    InjectedPartition,
    InjectedStall,
    Unreachable,
    VirtualClock,
)

from .query import _Z95, BatchResult, Query
from .service import StatsConfig, StreamStatsService

log = logging.getLogger(__name__)

# routing salt: distinct from every sampling salt so the shard partition is
# independent of the sample (a key's shard must not correlate with its
# inclusion randomness)
SALT_ROUTE = 0x5A3D


# ---------------------------------------------------------------------------
# Key routing
# ---------------------------------------------------------------------------


def route_keys(keys, n_shards: int, *, salt: int = SALT_ROUTE) -> np.ndarray:
    """Deterministic shard id per key: ``hash(salt, key) % n_shards``.

    Same counter-based hashing as the samplers (core.hashing), so the
    partition is a pure function of (salt, key) — stable across restarts,
    platforms, and batch boundaries.  Key-partitioned shards are what make
    the tier's one-pass merges unbiased."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    keys = normalize_keys(keys)
    # keys first: the array part makes every mixing op array-shaped (0-d
    # uint32 chains trip numpy's scalar-overflow warning)
    h = hashing.hash_combine_np(keys, np.uint32(salt))
    return (h % np.uint32(n_shards)).astype(np.int64)


def partition_batch(keys, weights, n_shards: int, *, salt: int = SALT_ROUTE):
    """Split one ingest batch into per-shard (keys, weights) sub-batches,
    preserving arrival order within each shard (mask selection is stable)."""
    keys = normalize_keys(keys)
    if weights is None:
        weights = np.ones(len(keys), np.float32)
    else:
        weights = np.asarray(weights, np.float32)
        if weights.shape != keys.shape:
            raise ValueError("weights must match keys")
    sid = route_keys(keys, n_shards, salt=salt)
    return [(keys[sid == s], weights[sid == s]) for s in range(n_shards)]


# ---------------------------------------------------------------------------
# Exceptions
# ---------------------------------------------------------------------------


class ShardDown(RuntimeError):
    """The shard's in-memory state is gone (crashed or never recovered)."""


class ExactUnavailable(RuntimeError):
    """Exact two-pass answers cannot be produced right now (a shard is down
    or mid-replay, or the WAL no longer covers the full stream)."""


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------


class WALCorrupt(ValueError):
    """A WAL segment's bytes fail integrity verification (short file,
    missing trailer, or CRC mismatch)."""


# Segment trailer: written AFTER the payload so a truncated/torn file can
# never carry a valid trailer — magic + crc32(payload) + payload length.
_WAL_TRAILER_MAGIC = b"WSG1"
_WAL_TRAILER = struct.Struct("<4sIQ")


class ShardWAL:
    """Per-shard durable log of routed batches, one ``wal_<seq>.npz`` per
    sequence number (1-based, contiguous).  Segments commit with the same
    fsync discipline as checkpoints (checkpoint.manager.fsync_file/_dir):
    write tmp, fsync data, rename, fsync directory — a host crash never
    surfaces a torn segment, and ``entries`` only ever sees committed ones.

    Integrity: every segment carries a CRC32 trailer over its ``.npz``
    payload (magic + crc + length, written after the payload — a torn tail
    cannot end in a valid trailer).  Replay verifies each segment; a
    corrupt segment in the MIDDLE of the log is unrecoverable data loss and
    raises.  A corrupt TAIL segment — the one case fs reordering or torn
    disk writes can plausibly produce — is tolerated: ``entries`` repairs
    it from the in-memory WAL-first buffer (the coordinator appended the
    batch moments ago and still holds it) or, if this process never wrote
    it, drops the segment with a logged warning so ``recover()`` completes
    on the verified prefix instead of crashing.
    """

    def __init__(self, dirpath, *, fsync: bool = True):
        self.dir = Path(dirpath)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        # WAL-first buffer: the most recent append, kept in memory until
        # superseded — the repair source for a torn tail segment.
        self._last: tuple[int, np.ndarray, np.ndarray] | None = None

    def _path(self, seq: int) -> Path:
        return self.dir / f"wal_{seq:08d}.npz"

    def append(self, seq: int, keys, weights) -> None:
        if seq < 1:
            raise ValueError("WAL sequence numbers are 1-based")
        keys = np.asarray(keys, np.int32)
        weights = np.asarray(weights, np.float32)
        path = self._path(seq)
        tmp = path.with_suffix(".npz.tmp")
        buf = io.BytesIO()
        np.savez(buf, keys=keys, weights=weights)
        payload = buf.getvalue()
        trailer = _WAL_TRAILER.pack(_WAL_TRAILER_MAGIC,
                                    zlib.crc32(payload), len(payload))
        with open(tmp, "wb") as f:
            f.write(payload)
            f.write(trailer)
        if self.fsync:
            ckpt_manager.fsync_file(tmp)
        os.replace(tmp, path)
        if self.fsync:
            ckpt_manager.fsync_dir(self.dir)
        self._last = (seq, keys, weights)

    def read_segment(self, seq: int) -> tuple[np.ndarray, np.ndarray]:
        """Read and VERIFY one committed segment; raises WALCorrupt if the
        bytes fail the trailer/CRC check."""
        raw = self._path(seq).read_bytes()
        if len(raw) < _WAL_TRAILER.size:
            raise WALCorrupt(f"WAL seq {seq}: {len(raw)} bytes, shorter "
                             "than the integrity trailer")
        magic, crc, length = _WAL_TRAILER.unpack(raw[-_WAL_TRAILER.size:])
        payload = raw[:-_WAL_TRAILER.size]
        if magic != _WAL_TRAILER_MAGIC or length != len(payload):
            raise WALCorrupt(f"WAL seq {seq}: torn segment (bad trailer; "
                             f"payload {len(payload)} bytes, trailer "
                             f"claims {length})")
        if zlib.crc32(payload) != crc:
            raise WALCorrupt(f"WAL seq {seq}: CRC32 mismatch")
        with np.load(io.BytesIO(payload)) as d:
            return d["keys"], d["weights"]

    def seqs(self) -> list[int]:
        return sorted(int(p.name[4:12]) for p in self.dir.glob("wal_*.npz"))

    def last_seq(self) -> int:
        s = self.seqs()
        return s[-1] if s else 0

    def check_tail(self) -> int:
        """Verify the last segment, repairing/dropping a torn tail (see
        ``entries``).  Returns the last VALID sequence number (0 when
        empty).  The process-mode supervisor runs this coordinator-side —
        where the WAL-first buffer lives — before asking a remote worker
        (whose ShardWAL instance has no buffer) to replay the log."""
        seqs = self.seqs()
        if not seqs:
            return 0
        tail = seqs[-1]
        try:
            self.read_segment(tail)
            return tail
        except WALCorrupt as e:
            if not self._repair_tail(tail, e):
                return tail - 1
            return tail

    def _repair_tail(self, seq: int, err: WALCorrupt) -> bool:
        """Torn tail handling: rewrite from the WAL-first buffer when this
        process still holds the batch, else drop the segment (logged)."""
        if self._last is not None and self._last[0] == seq:
            log.warning("%s: %s — repaired from the WAL-first buffer",
                        self.dir, err)
            self.append(seq, self._last[1], self._last[2])
            return True
        log.warning("%s: %s — dropped torn tail segment (no WAL-first "
                    "buffer in this process; replay stops at seq %d)",
                    self.dir, err, seq - 1)
        self._path(seq).unlink()
        if self.fsync:
            ckpt_manager.fsync_dir(self.dir)
        return False

    def entries(self, after: int = 0):
        """Yield committed, VERIFIED ``(seq, keys, weights)`` with seq >
        ``after`` in sequence order, verifying contiguity — a gap means the
        log was truncated past ``after`` and replay from there would drop
        batches.  A corrupt tail segment is repaired from the WAL-first
        buffer or dropped (replay ends one batch early, logged); a corrupt
        interior segment raises WALCorrupt."""
        expect = after
        seqs = self.seqs()
        for seq in seqs:
            if seq <= after:
                continue
            expect += 1
            if seq != expect:
                raise ValueError(
                    f"WAL gap: expected seq {expect}, found {seq} — the log "
                    f"was truncated past the requested replay point {after}")
            try:
                keys, weights = self.read_segment(seq)
            except WALCorrupt as e:
                if seq != seqs[-1]:
                    raise WALCorrupt(
                        f"{e} — segment is INTERIOR (last is {seqs[-1]}): "
                        "replaying past it would silently drop a batch"
                    ) from None
                if not self._repair_tail(seq, e):
                    return
                keys, weights = self.read_segment(seq)
            yield seq, keys, weights

    def truncate_through(self, seq: int) -> None:
        """Drop segments <= ``seq`` (their batches are inside a committed
        checkpoint).  Crash-safe: deletion after checkpoint commit means a
        crash in between only leaves extra segments, never missing ones."""
        for s in self.seqs():
            if s <= seq:
                self._path(s).unlink()
        if self.fsync:
            ckpt_manager.fsync_dir(self.dir)

    def covers_from_origin(self, through: int | None = None) -> bool:
        """True iff the retained log is the COMPLETE stream — seqs 1..last
        with no truncation, reaching at least ``through`` when given (an
        empty log trivially "covers" nothing, so exact pass II must demand
        coverage through the shard's applied sequence)."""
        s = self.seqs()
        if s != list(range(1, len(s) + 1)):
            return False
        return through is None or len(s) >= through


# ---------------------------------------------------------------------------
# Shard worker
# ---------------------------------------------------------------------------


class ShardWorker:
    """One in-process shard: an incremental sampler bank (StreamStatsService
    with ``host_id = shard_id``) behind fault-injection hooks, with
    checkpoint + WAL recovery.

    Every public operation is wrapped in a named injection site
    (``shard<i>.<op>``, see launch.faults.SITES).  An injected crash kills
    the in-memory state (``alive = False``); the durable state — committed
    checkpoints plus WAL segments — is all ``recover()`` needs to rebuild
    the exact pre-crash sketch, bit for bit.
    """

    def __init__(self, shard_id: int, config: StatsConfig, root, *,
                 checkpoint_every: int = 8, retain_wal: bool = False,
                 faults: FaultInjector | None = None, fsync: bool = True,
                 device=None):
        self.shard_id = int(shard_id)
        self.device = resolve_device(device)
        self.config = dataclasses.replace(config, host_id=self.shard_id)
        self.root = Path(root) / f"shard_{self.shard_id:02d}"
        self.ckpt_dir = self.root / "ckpt"
        self.wal = ShardWAL(self.root / "wal", fsync=fsync)
        self.checkpoint_every = int(checkpoint_every)
        self.retain_wal = bool(retain_wal)
        self._faults = faults if faults is not None else FaultInjector()
        self.service: StreamStatsService | None = StreamStatsService(
            self.config, device=self.device)
        self.applied_seq = 0      # last WAL sequence folded into the service
        self._last_ckpt_seq = 0
        self.alive = True

    # -- fault plumbing ----------------------------------------------------

    def _site(self, op: str) -> str:
        return f"shard{self.shard_id}.{op}"

    def _guarded(self, op: str, *, check_alive: bool = True) -> "_SiteGuard":
        """Injection wrapper: translates an injected crash into worker death
        (in-memory state gone) + ShardDown for the caller; stall/slow/lost-
        reply pass through as themselves (the coordinator's retry loop and
        idempotent apply handle those)."""
        return _SiteGuard(self, op, check_alive)

    def crash(self) -> None:
        """Simulate a process kill: in-memory state is gone; the durable
        checkpoint + WAL survive."""
        self.alive = False
        self.service = None

    def _check_alive(self) -> None:
        if not self.alive:
            raise ShardDown(f"shard {self.shard_id} is down")

    # -- operations (each behind its injection site) -----------------------

    def heartbeat(self) -> int:
        """Liveness probe; returns the applied sequence number (the
        coordinator's staleness signal)."""
        with self._guarded("heartbeat"):
            return self.applied_seq

    def apply(self, seq: int, keys, weights) -> int:
        """Fold one WAL batch into the sketch.  Idempotent: ``seq`` at or
        below ``applied_seq`` is an ack-only no-op — the retry path after a
        lost reply must not double-count elements.  Out-of-order gaps are an
        error (the coordinator always sends contiguous sequences)."""
        with self._guarded("ingest"):
            if seq > self.applied_seq:
                if seq != self.applied_seq + 1:
                    raise ValueError(
                        f"shard {self.shard_id}: apply gap — got seq {seq}, "
                        f"applied through {self.applied_seq}")
                self.service.observe(keys, weights)
                self.applied_seq = seq
        if (self.checkpoint_every
                and self.applied_seq - self._last_ckpt_seq >= self.checkpoint_every):
            self.checkpoint()
        return self.applied_seq

    def checkpoint(self) -> int:
        """Commit the sketch at the current applied sequence, then truncate
        the WAL through it (unless ``retain_wal``).  Commit-then-truncate:
        a crash in between leaves extra WAL segments, never a hole."""
        with self._guarded("checkpoint"):
            self.service.save_checkpoint(self.ckpt_dir, step=self.applied_seq)
            self._last_ckpt_seq = self.applied_seq
            if not self.retain_wal:
                self.wal.truncate_through(self.applied_seq)
            return self.applied_seq

    def service_view(self) -> StreamStatsService:
        """The live sketch service, for the coordinator's merge fold (the
        fold reads flushed state; it never mutates the worker)."""
        with self._guarded("query"):
            return self.service

    def recover(self) -> int:
        """Rebuild from durable state: restore the latest committed
        checkpoint (if any), then replay the WAL tail through ``observe``.

        Bit-identity property (tested): the rebuilt sketch equals the
        never-crashed worker's, because (a) checkpoints round-trip the full
        sampler state bit-for-bit including the sub-chunk remainder, and
        (b) the chunk partition of a stream depends only on the element
        sequence, which the WAL fixes.  Safe to call on a live worker too
        (e.g. to catch a stalled-but-alive shard up with its WAL): the
        rebuild is idempotent."""
        with self._guarded("recover", check_alive=False):
            svc = StreamStatsService(self.config, device=self.device)
            step = ckpt_manager.latest_step(self.ckpt_dir)
            applied = 0
            if step is not None:
                svc.restore_checkpoint(self.ckpt_dir, step)
                applied = step
            for seq, keys, weights in self.wal.entries(after=applied):
                svc.observe(keys, weights)
                applied = seq
            self.service = svc
            self.applied_seq = applied
            self._last_ckpt_seq = step or 0
            self.alive = True
            return applied

    @property
    def n_observed(self) -> int:
        self._check_alive()
        return self.service.n_observed

    def runtime_status(self) -> dict:
        """Coordinator-visible worker facts for the status plane.  NOT an
        RPC (no injection site): the coordinator reads its own bookkeeping
        mirror of the worker, so a down shard still reports.  The process-
        mode supervisor overrides this to add pid/restart facts."""
        return {
            "alive": self.alive,
            "applied_seq": self.applied_seq,
            "last_checkpoint_seq": self._last_ckpt_seq,
            "wal_depth": len(self.wal.seqs()),
        }


class _SiteGuard:
    """``with worker._guarded(op):`` — liveness check + injection site +
    crash translation, as a context manager usable around return-bearing
    bodies (a lost reply fires on exit, AFTER the body ran)."""

    def __init__(self, worker: ShardWorker, op: str, check_alive: bool = True):
        self.worker = worker
        self.op = op
        self.check_alive = check_alive
        self._cm = None

    def __enter__(self):
        if self.check_alive:
            self.worker._check_alive()
        self._cm = self.worker._faults.site(self.worker._site(self.op))
        try:
            self._cm.__enter__()
        except InjectedCrash:
            self._cm = None
            self.worker.crash()
            raise ShardDown(
                f"shard {self.worker.shard_id} crashed in {self.op}") from None
        return self

    def __exit__(self, exc_type, exc, tb):
        cm, self._cm = self._cm, None
        if cm is None:
            return False
        try:
            return cm.__exit__(exc_type, exc, tb)
        except InjectedCrash:
            self.worker.crash()
            raise ShardDown(
                f"shard {self.worker.shard_id} crashed in {self.op}") from None


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TierConfig:
    n_shards: int = 4
    # applied WAL batches between shard checkpoints (the durability /
    # recovery-time trade)
    checkpoint_every: int = 8
    # consecutive failed heartbeats before a shard is declared down
    heartbeat_miss_limit: int = 3
    # bounded retry on shard calls: attempts beyond the first
    max_retries: int = 3
    backoff_base_s: float = 0.05     # first retry delay
    backoff_factor: float = 2.0      # exponential growth per retry
    call_deadline_s: float = 2.0     # give up when backoff would pass this
    # keep the complete WAL (never truncate at checkpoints): required for
    # exact two-pass queries, costs O(stream) disk
    retain_wal: bool = False
    # immediately attempt recover() when a shard is declared down
    auto_recover: bool = True
    route_salt: int = SALT_ROUTE
    fsync: bool = True
    # Background exact-merge cadence: every N ingested
    # batches and/or every S (clock) seconds, fold the shard WALs into a
    # reconciled exact snapshot (merge_many(mode="exact") + full pass II)
    # served by query mode="snapshot" — exact as of its watermark, stamped
    # with element staleness — while approx queries keep serving from the
    # live sketches.  Requires retain_wal.  None disables the cadence.
    merge_every_n_batches: int | None = None
    merge_every_s: float | None = None


class ShardTier:
    """Coordinator over N key-partitioned shard workers.

    Ingest is WAL-first: every routed sub-batch is durable in the target
    shard's log *before* the shard call, so a crash at any point loses
    nothing — recovery replays the log.  Down shards keep accumulating WAL
    (their keys still route to them); ``recover_shard`` catches them up.

    Failure detection: ``check_health()`` heartbeats every member shard,
    counts consecutive misses, and declares a shard down past the miss
    limit (a crashed shard is declared immediately).  All shard calls run
    under bounded retry with exponential backoff + a deadline; with a
    ``VirtualClock`` (the default) backoff advances virtual time only, so
    chaos tests are fast and bit-deterministic.

    Membership: each slot is ``up`` / ``down`` / ``left``.  ``leave_shard``
    is the graceful decommission half of the elastic join/leave protocol
    (final checkpoint, slot keeps its WAL); ``join_shard`` revives the slot
    from durable state (launch/elastic.py demos the cycle).
    """

    def __init__(self, config: StatsConfig, tier: TierConfig | None = None,
                 root=None, *, faults: FaultInjector | None = None, device=None):
        if config.host_id is not None:
            raise ValueError(
                "ShardTier assigns host_ids (the shard ids); leave "
                "StatsConfig.host_id unset")
        self.tier = tier or TierConfig()
        if root is None:
            raise ValueError("ShardTier needs a durable root directory")
        self.root = Path(root)
        self.base_config = config
        self.device = resolve_device(device)
        self._faults = faults if faults is not None else FaultInjector()
        self.clock = self._faults.clock
        n = self.tier.n_shards
        if (self.tier.merge_every_n_batches or
                self.tier.merge_every_s is not None) and not self.tier.retain_wal:
            raise ValueError(
                "the background exact-merge cadence replays full WALs; set "
                "TierConfig.retain_wal=True with merge_every_*")
        self.workers = [self._make_worker(s) for s in range(n)]
        self.slots = ["up"] * n           # "up" | "down" | "left"
        self._next_seq = [1] * n          # next WAL sequence per shard
        self._routed = [0] * n            # elements routed per shard (truth)
        self._miss = [0] * n              # consecutive heartbeat misses
        self._version = 0                 # bumped on any state change
        self._merged_cache: dict = {}     # (mode, shards, version) -> service
        self.events: list[tuple[float, int, str, str]] = []  # observability
        # background exact-merge snapshot (None until the first refresh)
        self._snapshot: dict | None = None
        self._batches_since_merge = 0
        self._last_merge_t = self.clock.now()
        self._n_merges = 0
        self._n_merges_skipped = 0

    def _make_worker(self, s: int):
        """Worker factory — the ONE point subclasses override to swap the
        in-process ShardWorker for a real-subprocess client (procshard)."""
        return ShardWorker(s, self.base_config, self.root,
                           checkpoint_every=self.tier.checkpoint_every,
                           retain_wal=self.tier.retain_wal,
                           faults=self._faults, fsync=self.tier.fsync,
                           device=self.device)

    # -- bookkeeping -------------------------------------------------------

    def _bump(self) -> None:
        self._version += 1
        self._merged_cache.clear()

    def _log_event(self, shard: int, event: str, detail: str = "") -> None:
        self.events.append((self.clock.now(), shard, event, detail))

    def membership(self) -> dict[int, str]:
        return {s: self.slots[s] for s in range(self.tier.n_shards)}

    def live_shards(self) -> list[int]:
        return [s for s in range(self.tier.n_shards) if self.slots[s] == "up"]

    @property
    def n_observed(self) -> int:
        """Total elements routed into the tier (independent of shard state)."""
        return sum(self._routed)

    # -- bounded retry -----------------------------------------------------

    # Faults that are worth retrying: the callee may be alive and the
    # operation idempotent.  Partition (process mode: connection severed)
    # and Unreachable (real socket timeout) behave exactly like a stall.
    _RETRIABLE = (InjectedStall, InjectedLostReply, InjectedPartition,
                  Unreachable)

    def _call(self, s: int, desc: str, fn):
        """Run one shard call under bounded retry with exponential backoff
        and a deadline.  Crash -> immediate down (retrying a dead process
        is pointless); stall/lost-reply/partition/unreachable -> retry
        (apply is idempotent, so a lost reply retried is an ack-only
        no-op); budget exhausted -> down.  Returns ``(ok, value)``.

        A SUCCESSFUL call resets the shard's heartbeat miss counter: any
        completed operation proves liveness, so a shard that is slow on
        heartbeats but still applying batches is never flapped to dead by
        heartbeat misses alone."""
        cfg = self.tier
        delay = cfg.backoff_base_s
        deadline = self.clock.now() + cfg.call_deadline_s
        attempt = 0
        while True:
            try:
                out = fn()
            except ShardDown as e:
                self._mark_down(s, f"{desc}: {e}")
                return False, None
            except self._RETRIABLE as e:
                attempt += 1
                if attempt > cfg.max_retries or self.clock.now() + delay > deadline:
                    self._mark_down(
                        s, f"{desc}: retry budget exhausted after {attempt} "
                           f"attempts ({type(e).__name__})")
                    return False, None
                self.clock.sleep(delay)
                delay *= cfg.backoff_factor
            else:
                self._miss[s] = 0
                return True, out

    def _mark_down(self, s: int, reason: str) -> None:
        if self.slots[s] == "down":
            return
        self.slots[s] = "down"
        self._miss[s] = 0
        self._bump()
        self._log_event(s, "down", reason)
        if self.tier.auto_recover:
            self.recover_shard(s)

    # -- failure detection -------------------------------------------------

    def check_health(self) -> dict[int, str]:
        """One heartbeat round over every member shard.  A crashed shard is
        declared down immediately; a stalled/unresponsive one accumulates
        misses and is declared down at the miss limit.  A responsive shard
        currently marked down (e.g. recovery succeeded but its reply was
        lost) is brought back through ``recover_shard`` — recovery is
        idempotent, so this also catches the shard up with any WAL batches
        routed while it was out.  A DEAD shard already marked down (its
        recovery attempt itself crashed) is retried under ``auto_recover``:
        ``_mark_down`` is a no-op on an already-down shard, so without the
        retry here a crash-during-recover would wedge the slot forever."""
        for s in range(self.tier.n_shards):
            if self.slots[s] == "left":
                continue
            try:
                self.workers[s].heartbeat()
            except ShardDown as e:
                was_down = self.slots[s] == "down"
                self._mark_down(s, f"heartbeat: {e}")
                if was_down and self.tier.auto_recover:
                    self.recover_shard(s)
                continue
            except self._RETRIABLE as e:
                self._miss[s] += 1
                self._log_event(s, "miss",
                                f"{self._miss[s]}/{self.tier.heartbeat_miss_limit}"
                                f" ({type(e).__name__})")
                if self._miss[s] >= self.tier.heartbeat_miss_limit:
                    self._mark_down(s, "heartbeat miss limit")
                continue
            self._miss[s] = 0
            if self.slots[s] == "down":
                self.recover_shard(s)
        return self.membership()

    # -- recovery ----------------------------------------------------------

    def recover_shard(self, s: int) -> bool:
        """Restart shard ``s`` from its durable state (checkpoint restore +
        WAL replay).  On success the shard is up AND caught up with every
        batch routed to it, including ones routed while it was down."""
        if self.slots[s] == "left":
            raise ValueError(f"shard {s} left the tier; use join_shard")
        self._bump()
        t0 = self.clock.now()
        try:
            applied = self.workers[s].recover()
        except ShardDown:
            self._log_event(s, "recover_failed", "crashed during recovery")
            self.slots[s] = "down"
            return False
        except self._RETRIABLE as e:
            # a lost recovery reply may leave the worker healthy; the next
            # health round's heartbeat brings the slot back
            self._log_event(s, "recover_failed", type(e).__name__)
            self.slots[s] = "down"
            return False
        self.slots[s] = "up"
        self._miss[s] = 0
        self._log_event(s, "recovered",
                        f"applied through seq {applied} "
                        f"in {self.clock.now() - t0:g}s")
        return True

    def kill_shard(self, s: int) -> None:
        """Test/chaos hook: hard-kill a shard's in-memory state without
        telling the coordinator (detection happens via heartbeats/calls)."""
        self.workers[s].crash()

    # -- ingest ------------------------------------------------------------

    def ingest(self, keys, weights=None) -> dict[int, int]:
        """Route one batch to the shards, WAL-first.  Returns the number of
        elements routed per shard.  Down/left shards still get their WAL
        appends (losing a shard must not lose its keys' data) and catch up
        at recovery/join."""
        parts = partition_batch(keys, weights, self.tier.n_shards,
                                salt=self.tier.route_salt)
        self._bump()
        routed = {}
        for s, (pk, pw) in enumerate(parts):
            if len(pk) == 0:
                continue
            seq = self._next_seq[s]
            self.workers[s].wal.append(seq, pk, pw)  # durable BEFORE the call
            self._next_seq[s] = seq + 1
            self._routed[s] += len(pk)
            routed[s] = len(pk)
            if self.slots[s] != "up":
                continue  # replayed at recovery
            self._call(s, f"apply seq {seq}",
                       lambda w=self.workers[s], q=seq, a=pk, b=pw:
                       w.apply(q, a, b))
        self._batches_since_merge += 1
        self._maybe_refresh_snapshot()
        return routed

    # -- background exact-merge snapshot -----------------------------------

    def _merge_due(self) -> bool:
        cfg = self.tier
        if (cfg.merge_every_n_batches
                and self._batches_since_merge >= cfg.merge_every_n_batches):
            return True
        if (cfg.merge_every_s is not None
                and self.clock.now() - self._last_merge_t >= cfg.merge_every_s):
            return True
        return False

    def _maybe_refresh_snapshot(self) -> bool:
        """Cadence hook (end of every ingest): refresh the exact snapshot
        when the configured cadence has elapsed.  A refresh that cannot run
        right now (shard down, WAL truncated) is SKIPPED, not fatal —
        approx queries keep serving and the cadence retries next batch."""
        if not self._merge_due():
            return False
        return self.refresh_snapshot()

    def refresh_snapshot(self) -> bool:
        """Fold every shard's WAL into a reconciled exact snapshot NOW.

        The snapshot is a frozen scratch service answering ``mode=
        "snapshot"`` queries — exact as of its watermark (every element
        routed before the fold), stamped with how many elements arrived
        since.  Returns False (and logs a ``merge_skipped`` event) when
        exact state is unreachable; the live approx path is unaffected."""
        t0 = self.clock.now()
        try:
            scratch = self._merged_exact()
        except ExactUnavailable as e:
            self._n_merges_skipped += 1
            self._log_event(-1, "merge_skipped", str(e))
            return False
        self._snapshot = {
            "service": scratch,
            "watermark_elements": self.n_observed,
            "watermark_seqs": tuple(q - 1 for q in self._next_seq),
            "built_at": self.clock.now(),
            "build_s": self.clock.now() - t0,
        }
        self._n_merges += 1
        self._batches_since_merge = 0
        self._last_merge_t = self.clock.now()
        self._log_event(-1, "merged",
                        f"exact snapshot at {self.n_observed} elements "
                        f"in {self._snapshot['build_s']:g}s")
        return True

    def snapshot_staleness(self) -> int | None:
        """Elements routed since the current exact snapshot's watermark
        (None when no snapshot exists yet) — the estimate-staleness the
        merge cadence trades against merge cost."""
        if self._snapshot is None:
            return None
        return self.n_observed - self._snapshot["watermark_elements"]

    # -- status plane ------------------------------------------------------

    def status(self, *, events_tail: int = 32) -> dict:
        """Flexlb-style load/status plane: one JSON-serializable dict the
        serving layer can poll/scrape without touching any worker RPC —
        everything here is coordinator bookkeeping plus each worker's
        ``runtime_status`` mirror, so a wedged shard cannot wedge status.

        Shape::

            {"shards": {i: {state, load, share, heartbeat_misses,
                            alive, applied_seq, last_checkpoint_seq,
                            wal_depth, ...proc facts...}},
             "coverage": float,       # routed-element fraction on up shards
             "n_observed": int, "membership": {...},
             "snapshot": {...} | None,  # exact-merge tier watermark/cadence
             "events": [[t, shard, event, detail], ...]}  # most recent
        """
        total = sum(self._routed)
        shards: dict[int, dict] = {}
        covered = 0
        for s in range(self.tier.n_shards):
            st = {
                "state": self.slots[s],
                "load": self._routed[s],
                "share": (self._routed[s] / total) if total else 0.0,
                "heartbeat_misses": self._miss[s],
            }
            st.update(self.workers[s].runtime_status())
            shards[s] = st
            if self.slots[s] == "up":
                covered += self._routed[s]
        snap = None
        if self._snapshot is not None:
            snap = {
                "watermark_elements": self._snapshot["watermark_elements"],
                "staleness_elements": self.snapshot_staleness(),
                "built_at": self._snapshot["built_at"],
                "build_s": self._snapshot["build_s"],
            }
        return {
            "shards": shards,
            "coverage": (covered / total) if total else 1.0,
            "n_observed": total,
            "membership": self.membership(),
            "snapshot": snap,
            "merges": {"done": self._n_merges,
                       "skipped": self._n_merges_skipped,
                       "batches_since": self._batches_since_merge},
            "events": [list(e) for e in self.events[-events_tail:]],
        }

    # -- queries -----------------------------------------------------------

    def _shard_services(self):
        """Collect the live shards' service views (a failing view marks that
        shard down and excludes it).  Returns ``[(shard, service), ...]``."""
        views = []
        for s in list(self.live_shards()):
            ok, svc = self._call(s, "query view",
                                 lambda w=self.workers[s]: w.service_view())
            if ok and self.slots[s] == "up":
                views.append((s, svc))
        return views

    def _merged_approx(self):
        """One-pass fold of the surviving shards into a scratch service.
        Cached per (membership, version) — repeated queries between state
        changes reuse the fold AND the scratch service's engine caches."""
        views = self._shard_services()
        shards = tuple(s for s, _ in views)
        key = ("approx", shards, self._version)
        hit = self._merged_cache.get(key)
        if hit is not None:
            return hit
        scratch = StreamStatsService(dataclasses.replace(
            self.base_config, host_id=self.tier.n_shards), device=self.device)
        # key-partitioned shards: the one-pass fold is unbiased even for a
        # subset (each key's full stream is on exactly one shard)
        scratch.merge_many([svc for _, svc in views], mode="approx")
        self._merged_cache = {key: (scratch, shards)}
        return scratch, shards

    def _merged_exact(self):
        """Full two-pass: exact merge of every shard's lossless summaries,
        then pass II replays each complete WAL through ``reconcile`` (each
        batch one fold launch on a card: sums in element order, so the
        answer is the same bits on every run)."""
        n = self.tier.n_shards
        not_up = [s for s in range(n) if self.slots[s] != "up"]
        if not_up:
            raise ExactUnavailable(
                f"shards {not_up} are not up — pass II cannot reach the "
                "whole stream")
        key = ("exact", tuple(range(n)), self._version)
        hit = self._merged_cache.get(key)
        if hit is not None:
            return hit
        for s in range(n):
            if not self.workers[s].wal.covers_from_origin(
                    self.workers[s].applied_seq):
                raise ExactUnavailable(
                    f"shard {s}'s WAL was truncated at a checkpoint — exact "
                    "pass II needs the full stream (TierConfig.retain_wal)")
        views = self._shard_services()
        if len(views) != n:
            raise ExactUnavailable(
                "lost a shard while collecting pass-I summaries")
        scratch = StreamStatsService(dataclasses.replace(
            self.base_config, host_id=n), device=self.device)
        scratch.merge_many([svc for _, svc in views], mode="exact")
        scratch.begin_reconcile()
        for s in range(n):
            for _seq, keys, weights in self.workers[s].wal.entries(after=0):
                scratch.reconcile(keys, weights)
        self._merged_cache = {key: scratch}
        return scratch

    def _stamp(self, res: BatchResult, *, coverage: float, stale: int,
               degraded: bool, mode: str) -> BatchResult:
        if degraded and 0.0 < coverage < 1.0:
            # shard-inclusion Horvitz-Thompson scaling: a key's whole stream
            # lives on one shard, and the reachable shards cover ``coverage``
            # of the routed elements — scale up by the inverse, and widen
            # the variance by the unscaled estimator's variance growth plus
            # a missing-mass term (the unseen shards' contribution is
            # unknown, so the stamp is a diagnostic envelope, not a CI)
            inv = 1.0 / coverage
            est = res.estimates * inv
            var = res.variances * inv * inv + np.square(est) * (1.0 - coverage)
            stderr = np.sqrt(var)
            res = dataclasses.replace(
                res, estimates=est, variances=var, stderr=stderr,
                ci_low=est - _Z95 * stderr, ci_high=est + _Z95 * stderr)
        return dataclasses.replace(
            res, coverage=coverage, staleness_elements=stale,
            degraded=degraded, mode=mode)

    def query_batch(self, queries, *, mode: str = "approx") -> BatchResult:
        """Answer a query batch from the tier.

        mode="approx": one-pass fold of the surviving shards.  With every
        shard up this is the tier's normal answer (coverage 1.0, not
        degraded).  With shards down, answers carry the degradation stamp:
        coverage fraction, staleness count, HT-scaled estimates, widened
        diagnostics.

        mode="exact": the full two-pass answer (requires ``retain_wal`` and
        every shard up), bit-identical across crash/recover histories.
        Raises ExactUnavailable otherwise.

        mode="auto": exact when available, degraded approx fallback.

        mode="snapshot": serve from the background exact-merge snapshot —
        exact as of its watermark, stamped with ``staleness_elements`` =
        elements routed since (coverage 1.0, not degraded: the answer is
        exact over everything it claims to cover).  Raises ExactUnavailable
        before the first snapshot exists.
        """
        if mode not in ("approx", "exact", "auto", "snapshot"):
            raise ValueError(f"unknown tier query mode {mode!r}")
        if mode == "snapshot":
            snap = self._snapshot
            if snap is None:
                raise ExactUnavailable(
                    "no exact snapshot yet — set a merge cadence "
                    "(TierConfig.merge_every_*) or call refresh_snapshot()")
            res = snap["service"].query_batch(queries, exact=True)
            return self._stamp(
                res, coverage=1.0,
                stale=self.n_observed - snap["watermark_elements"],
                degraded=False, mode="snapshot")
        if mode in ("exact", "auto"):
            try:
                scratch = self._merged_exact()
                res = scratch.query_batch(queries, exact=True)
                return self._stamp(res, coverage=1.0, stale=0,
                                   degraded=False, mode="exact")
            except ExactUnavailable:
                if mode == "exact":
                    raise
        scratch, shards = self._merged_approx()
        res = scratch.query_batch(queries, exact=False)
        total = sum(self._routed)
        covered = sum(self._routed[s] for s in shards)
        coverage = (covered / total) if total else 1.0
        return self._stamp(res, coverage=coverage, stale=total - covered,
                           degraded=coverage < 1.0, mode="approx")

    def query_cap(self, T: float, segment=None, *, mode: str = "approx") -> float:
        from ..core import freqfns
        r = self.query_batch([Query(freqfns.cap(T), segment)], mode=mode)
        return float(r.estimates[0])

    def query_distinct(self, segment=None, *, mode: str = "approx") -> float:
        from ..core import freqfns
        r = self.query_batch([Query(freqfns.distinct(), segment)], mode=mode)
        return float(r.estimates[0])

    def query_total(self, segment=None, *, mode: str = "approx") -> float:
        from ..core import freqfns
        r = self.query_batch([Query(freqfns.total(), segment)], mode=mode)
        return float(r.estimates[0])

    # -- elastic membership ------------------------------------------------

    def leave_shard(self, s: int) -> Path:
        """Graceful decommission: final checkpoint, slot marked ``left``.
        The slot's WAL keeps accumulating (its keys still route to it), so
        a later ``join_shard`` catches the replacement up losslessly.
        Returns the slot's durable state directory (the handoff blob)."""
        if self.slots[s] != "up":
            raise ValueError(f"shard {s} is {self.slots[s]}; cannot leave")
        ok, _ = self._call(s, "leave checkpoint",
                           lambda w=self.workers[s]: w.checkpoint())
        if not ok:
            raise RuntimeError(
                f"shard {s} failed its final checkpoint; recover it first")
        self.workers[s].crash()  # release in-memory state
        self.slots[s] = "left"
        self._bump()
        self._log_event(s, "left", "graceful decommission")
        return self.workers[s].root

    def join_shard(self, s: int) -> bool:
        """Revive slot ``s`` as a fresh worker (a new process) from the
        slot's durable state: checkpoint restore + WAL tail replay."""
        if self.slots[s] != "left":
            raise ValueError(f"shard {s} is {self.slots[s]}; join revives "
                             "decommissioned slots (use recover_shard for "
                             "crashed ones)")
        self.workers[s] = self._make_worker(s)
        self.slots[s] = "down"  # recover_shard flips to up on success
        self._bump()
        self._log_event(s, "joining", "fresh worker over durable slot state")
        return self.recover_shard(s)
