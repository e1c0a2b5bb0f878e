"""Continuous-batching scheduler for the multi-tenant serving plane (port of
``repro/stats/scheduler.py``).

Glues three planes together:

* **Admission** — per-tenant FIFO queues for ingest and query requests,
  drained round-robin with a rotating start pointer so no tenant can
  starve another regardless of submission skew (one request per tenant
  per rotation, repeated until the step budget is spent).
* **Coalescing** — all admitted queries, across every tenant, become ONE
  ``QueryEngine`` dispatch batch (lane keys ``(tenant, l)``); all admitted
  ingest lands in the bank's staging queues and one stacked ``tick()``
  advances every tenant with a full chunk buffered.
* **Overlap** — within a step the query batch's device pass is enqueued
  first (against the refreshed snapshot), then the ingest tick's launches,
  and only then does the host block — on the query result alone.  Neither
  ``query_batch_async`` nor ``tick`` waits for the device, so the card runs
  the two back to back on one stream; the next step's ``refresh()`` is the
  single point that waits for ingest.

        step t:   refresh ─┐ (sync prior ticks)
        host      admit ─ enqueue Q(t) ─ enqueue I(t) ─ block on Q(t)
        device    ───────── [ Q(t) ▸▸▸ ][ I(t) ▸▸▸ ]──────▸ (t+1)

Results are buffered per request id and **evicted on read**
(``pop_result``) so a long-running server's memory stays bounded by the
outstanding-request window, not its lifetime.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from ..core import freqfns
from .service import MultiTenantStats, TenantQuery


@dataclasses.dataclass
class ServeConfig:
    """Per-step budgets + cadences for StatsScheduler."""

    max_ingest_per_step: int = 64     # ingest requests admitted per step
    max_queries_per_step: int = 256   # queries coalesced into one dispatch
    # rebuild the query snapshot at most every N steps while ingest is hot
    # (1 = every step => freshest answers, more sync; larger = staler
    # answers, longer uninterrupted overlap runs)
    refresh_every: int = 1
    max_ticks_per_step: int = 1       # stacked ingest dispatches per step
    # backpressure: per-tenant admission queue depth (ingest and query
    # queues separately).  ``submit_*`` past the limit raises QueueFull —
    # a RETRIABLE rejection — instead of letting one unthrottled client
    # grow the backlog without bound.  None = unbounded (legacy behavior).
    max_queue_depth: int | None = None
    # result expiry: a completed QueryRecord never ``pop_result``-ed within
    # this many subsequent steps is evicted (an abandoned client must not
    # leak the result buffer).  None = records live until popped.
    result_ttl_steps: int | None = None


class QueueFull(RuntimeError):
    """Admission rejected: the tenant's queue is at ``max_queue_depth``.

    Retriable by contract (``retriable = True``): the client should back
    off and resubmit — nothing was enqueued, and the server sheds load
    instead of buffering it."""

    retriable = True

    def __init__(self, plane: str, tenant: int, depth: int):
        super().__init__(
            f"{plane} queue for tenant {tenant} is full ({depth} deep) — "
            "retry after the scheduler drains")
        self.plane = plane
        self.tenant = tenant
        self.depth = depth


@dataclasses.dataclass
class QueryRecord:
    """One completed query: the answer + diagnostics + latency."""

    req_id: int
    tenant: int
    estimate: float
    stderr: float
    ci_low: float
    ci_high: float
    lane: float
    latency_s: float
    done_step: int = 0   # scheduler step that completed it (TTL accounting)


def _round_robin(queues: dict[int, deque], start: int, n_tenants: int,
                 budget: int) -> list[tuple[int, object]]:
    """Pop up to ``budget`` items fairly as (tenant, item) pairs: one per
    tenant per rotation, beginning at ``start`` and wrapping, until the
    budget is spent or every queue is empty.  A tenant with a deep backlog
    gets exactly as many slots per rotation as a tenant with one request."""
    out: list[tuple[int, object]] = []
    while budget > 0:
        took = 0
        for i in range(n_tenants):
            t = (start + i) % n_tenants
            q = queues.get(t)
            if q:
                out.append((t, q.popleft()))
                took += 1
                budget -= 1
                if budget == 0:
                    break
        if took == 0:
            break
    return out


class StatsScheduler:
    """Continuous-batching front end over one ``MultiTenantStats`` plane.

    Usage (see launch/stats_serve.py for the full server)::

        svc = MultiTenantStats(StatsConfig(...), n_tenants=64)
        sched = StatsScheduler(svc)
        sched.submit_ingest(tenant=3, keys=arr)
        rid = sched.submit_query(3, freqfns.cap(8.0))
        done = sched.step()          # one overlapped serve iteration
        rec = sched.pop_result(rid)  # evicts the record on read
    """

    def __init__(self, service: MultiTenantStats,
                 config: ServeConfig | None = None, *,
                 clock: Callable[[], float] = time.perf_counter):
        self.service = service
        self.config = config or ServeConfig()
        self._clock = clock
        T = service.n_tenants
        self._ingest_q: dict[int, deque] = {t: deque() for t in range(T)}
        self._query_q: dict[int, deque] = {t: deque() for t in range(T)}
        self._rr_ingest = 0
        self._rr_query = 0
        self._next_id = 0
        self._results: dict[int, QueryRecord] = {}
        self._steps_since_refresh = 0
        # counters (monotone, for throughput reporting)
        self.n_elements_ingested = 0
        self.n_queries_answered = 0
        self.n_results_expired = 0
        self.n_steps = 0

    # -- submission --------------------------------------------------------

    def submit_ingest(self, tenant: int, keys, weights=None) -> None:
        """Queue a stream slice for one tenant (admitted at a later step).
        Raises QueueFull (retriable) at ``ServeConfig.max_queue_depth``."""
        self._check_tenant(tenant)
        self._check_depth("ingest", self._ingest_q, tenant)
        self._ingest_q[tenant].append((np.asarray(keys), weights))

    def submit_query(self, tenant: int, fn: freqfns.FreqFn, segment=None,
                     l: float | None = None) -> int:
        """Queue a statistic request; returns the request id to poll.
        Raises QueueFull (retriable) at ``ServeConfig.max_queue_depth``."""
        self._check_tenant(tenant)
        self._check_depth("query", self._query_q, tenant)
        rid = self._next_id
        self._next_id += 1
        self._query_q[tenant].append(
            (rid, TenantQuery(tenant, fn, segment, l), self._clock()))
        return rid

    def _check_tenant(self, tenant: int) -> None:
        if not (0 <= tenant < self.service.n_tenants):
            raise ValueError(f"tenant {tenant} out of range "
                             f"[0, {self.service.n_tenants})")

    def _check_depth(self, plane: str, queues: dict[int, deque],
                     tenant: int) -> None:
        depth = self.config.max_queue_depth
        if depth is not None and len(queues[tenant]) >= depth:
            raise QueueFull(plane, tenant, depth)

    # -- results -----------------------------------------------------------

    def pop_result(self, req_id: int) -> QueryRecord | None:
        """Take (and EVICT) a completed query's record; None if pending."""
        return self._results.pop(req_id, None)

    @property
    def pending_queries(self) -> int:
        return sum(len(q) for q in self._query_q.values())

    @property
    def pending_ingest(self) -> int:
        return sum(len(q) for q in self._ingest_q.values())

    @property
    def buffered_results(self) -> int:
        return len(self._results)

    # -- the serve loop ----------------------------------------------------

    def step(self) -> list[int]:
        """One overlapped serve iteration; returns completed request ids.

        Order is the overlap contract (module docstring): admit → refresh
        (only when due AND queries are waiting) → enqueue the coalesced
        query dispatch → enqueue the stacked ingest tick(s) → block on the
        query result only.
        """
        cfg = self.config
        self.n_steps += 1
        T = self.service.n_tenants

        # 0) expire abandoned results: records not popped within the TTL
        #    window are evicted so a vanished client cannot leak the buffer.
        if cfg.result_ttl_steps is not None:
            expired = [rid for rid, rec in self._results.items()
                       if self.n_steps - rec.done_step >= cfg.result_ttl_steps]
            for rid in expired:
                del self._results[rid]
            self.n_results_expired += len(expired)

        # 1) admit ingest fairly into the bank's staging queues (host-side
        #    numpy appends — no device work yet).
        admitted = _round_robin(self._ingest_q, self._rr_ingest, T,
                                cfg.max_ingest_per_step)
        self._rr_ingest = (self._rr_ingest + 1) % max(T, 1)
        for tenant, (keys, weights) in admitted:
            self.service.observe(tenant, keys, weights)
            self.n_elements_ingested += int(np.asarray(keys).size)

        # 2) admit queries fairly and coalesce across tenants.
        picked = _round_robin(self._query_q, self._rr_query, T,
                              cfg.max_queries_per_step)
        self._rr_query = (self._rr_query + 1) % max(T, 1)

        # 3) refresh the snapshot only when it pays: queries are waiting
        #    and the snapshot is stale and the cadence is due (or there is
        #    no engine yet).  Only the admitted batch's tenants are
        #    materialized (partial refresh — the dominant snapshot cost is
        #    per-tenant).  This is the one sync point with prior ticks.
        self._steps_since_refresh += 1
        if picked and self.service.stale and (
                self._steps_since_refresh >= cfg.refresh_every
                or not self.service.has_engine):
            self.service.refresh(tenants={t for t, _ in picked})
            self._steps_since_refresh = 0

        # 4) enqueue the ONE coalesced query dispatch (no host sync).
        pending = None
        if picked:
            pending = self.service.query_batch_async(
                [tq for _, (_, tq, _) in picked], auto_refresh=False)

        # 5) enqueue the stacked ingest tick(s): device work for tick t+1
        #    runs while the query batch is still in flight.
        for _ in range(cfg.max_ticks_per_step):
            if self.service.tick() == 0:
                break

        # 6) block — on the query result only.
        done: list[int] = []
        if pending is not None:
            batch = pending.result()
            now = self._clock()
            for j, (tenant, (rid, _tq, t_submit)) in enumerate(picked):
                self._results[rid] = QueryRecord(
                    req_id=rid, tenant=tenant,
                    estimate=float(batch.estimates[j]),
                    stderr=float(batch.stderr[j]),
                    ci_low=float(batch.ci_low[j]),
                    ci_high=float(batch.ci_high[j]),
                    lane=float(batch.lanes[j]),
                    latency_s=now - t_submit,
                    done_step=self.n_steps)
                done.append(rid)
            self.n_queries_answered += len(done)
        return done

    def drain(self, *, max_steps: int = 1_000_000) -> list[int]:
        """Step until every queued request is admitted and answered and the
        bank's backlog is fully ingested (remainders stay staged, as in the
        single-tenant service).  Returns all request ids completed."""
        done: list[int] = []
        for _ in range(max_steps):
            idle = (self.pending_ingest == 0 and self.pending_queries == 0
                    and int(self.service.backlog_chunks().sum()) == 0)
            if idle:
                break
            done.extend(self.step())
        return done
