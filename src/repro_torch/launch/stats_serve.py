"""Multi-tenant stats server: a stacked bank, continuous batching, overlap
(port of ``repro/launch/stats_serve.py``).

Randomness boundary: the synthetic driver in ``main`` draws its workload
from ``np.random``; library-side randomness (sampling scores, eviction
races, merge coordination) derives only from the salted ``(key, eid)``
hashes in ``core/hashing.py``.

The serving tier for frequency-cap statistics.  N tenants' sketch grids
live in ONE stacked bank (``MultiTenantStats`` over
``core.incremental.TenantBank``: one ``chunksort`` and one ``capscore_agg``
launch per ingest tick for all active tenants); a continuous-batching
scheduler (``stats.scheduler.StatsScheduler``) admits ingest and query
requests with per-tenant round-robin fairness, coalesces every admitted
query -- across tenants -- into one ``QueryEngine`` pass, and overlaps the
next ingest tick's device work with the in-flight query batch.

Usage
-----
Programmatic (the server is a library first)::

    from repro_torch.core import freqfns
    from repro_torch.stats.service import StatsConfig, MultiTenantStats
    from repro_torch.stats.scheduler import StatsScheduler, ServeConfig

    svc = MultiTenantStats(StatsConfig(k=1024, ls=(1.0, 8.0, 64.0)),
                           n_tenants=64)
    sched = StatsScheduler(svc, ServeConfig(max_queries_per_step=256))

    sched.submit_ingest(tenant=3, keys=impression_keys)   # enqueue stream
    rid = sched.submit_query(3, freqfns.cap(8.0))         # enqueue query
    sched.step()                  # one overlapped serve iteration
    rec = sched.pop_result(rid)   # QueryRecord (evicted on read)

Command line (synthetic 64-tenant open-loop workload; without ``--device``
it runs on the CUDA card and raises where there is none)::

    PYTHONPATH=src python -m repro_torch.launch.stats_serve \
        --tenants 64 --steps 40 --requests 400 [--device cpu]

Checkpointing: ``svc.save_checkpoint(dir, step)`` writes the whole bank as
[T, ...]-stacked leaves; restore everything with ``restore_checkpoint`` or
one tenant with ``checkpoint.manager.restore_slice`` (the handoff path).

``StatsServer`` below is the single-service shell (one stream embedded in
a pipeline); for multi-tenant serving use the scheduler.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import freqfns
from ..core.incremental import resolve_device
from ..core.segments import HashBucket
from ..stats.query import BatchResult, Query
from ..stats.scheduler import ServeConfig, StatsScheduler
from ..stats.service import MultiTenantStats, StatsConfig, StreamStatsService


class StatsServer:
    """Request-batching shell around ONE StreamStatsService.

    ``submit`` enqueues a query; ``step`` ingests the next stream batch and
    answers pending queries in FIFO ``max_batch``-sized dispatch slices.
    By default a step drains the whole backlog (a burst of B requests
    completes in ceil(B / max_batch) dispatches within one step instead of
    starving across B / max_batch steps); ``drain=False`` answers a single
    slice per step for strict latency pacing.

    Results are buffered per request id and evicted on ``pop_result`` so a
    long-lived server holds only unread answers.
    """

    def __init__(self, service: StreamStatsService, *, max_batch: int = 64):
        self.service = service
        self.max_batch = max_batch
        self.pending: list[tuple[int, Query]] = []
        self.results: dict[int, dict] = {}
        self.batch_sizes: list[int] = []

    def submit(self, req_id: int, fn, segment=None) -> None:
        self.pending.append((req_id, Query(fn, segment)))

    def pop_result(self, req_id: int) -> dict | None:
        """Take (and EVICT) a completed query's answer; None if pending."""
        return self.results.pop(req_id, None)

    def step(self, keys=None, weights=None, *, drain: bool = True) -> list[int]:
        """Ingest one stream batch (if any), then answer pending queries.

        ``drain=True`` (default) empties the backlog in FIFO max_batch
        slices; ``drain=False`` answers at most one slice.
        """
        if keys is not None and len(keys):
            self.service.observe(keys, weights)
        done: list[int] = []
        while self.pending:
            take, self.pending = (self.pending[: self.max_batch],
                                  self.pending[self.max_batch:])
            ids = [rid for rid, _ in take]
            batch: BatchResult = self.service.query_batch([q for _, q in take])
            for i, rid in enumerate(ids):
                self.results[rid] = {
                    "estimate": float(batch.estimates[i]),
                    "stderr": float(batch.stderr[i]),
                    "ci": (float(batch.ci_low[i]), float(batch.ci_high[i])),
                    "l": float(batch.lanes[i]),
                    "n_keys": int(batch.n_keys[i]),
                }
            self.batch_sizes.append(len(ids))
            done.extend(ids)
            if not drain:
                break
        return done


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-tenant frequency-cap stats server (synthetic load)")
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--stream-batch", type=int, default=2048,
                    help="elements per tenant ingest request")
    ap.add_argument("--ingest-per-step", type=int, default=16,
                    help="tenants submitting an ingest request each step")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="queries coalesced into one dispatch")
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card ('cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    svc = MultiTenantStats(
        StatsConfig(k=args.k, ls=(1.0, 8.0, 64.0), chunk=args.chunk),
        n_tenants=args.tenants, device=device)
    sched = StatsScheduler(svc, ServeConfig(
        max_ingest_per_step=args.ingest_per_step,
        max_queries_per_step=args.max_batch))

    # synthetic ad workload: per-tenant zipf impression streams; advertisers
    # ask for many (cap T, audience segment) cells — the paper's inherently
    # many-T many-segment query mix, multiplexed across tenants
    caps = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]
    segments = [None] + [HashBucket(8, b) for b in range(8)]
    arrivals = rng.poisson(args.requests / args.steps, size=args.steps)

    next_req, finished, lat = 0, 0, []
    t0 = time.time()
    for step in range(args.steps):
        for t in rng.choice(args.tenants,
                            size=min(args.ingest_per_step, args.tenants),
                            replace=False):
            keys = (rng.zipf(1.3, size=args.stream_batch) % 100_000).astype(
                np.int64)
            sched.submit_ingest(int(t), keys)
        for _ in range(int(arrivals[step])):
            if next_req >= args.requests:
                break
            sched.submit_query(
                int(rng.integers(args.tenants)),
                freqfns.cap(float(rng.choice(caps))),
                segments[int(rng.integers(len(segments)))])
            next_req += 1
        done = sched.step()
        for rid in done:
            rec = sched.pop_result(rid)
            lat.append(rec.latency_s)
        finished += len(done)
        if done:
            print(f"[stats-serve] step {step:3d}: {len(done):3d} queries in "
                  f"one coalesced dispatch, backlog "
                  f"{int(sched.service.backlog_chunks().sum())} chunks")
    for rid in sched.drain():
        rec = sched.pop_result(rid)
        lat.append(rec.latency_s)
        finished += 1
    dt = time.time() - t0

    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50 = float(np.percentile(lat_ms, 50)) if len(lat_ms) else 0.0
    p99 = float(np.percentile(lat_ms, 99)) if len(lat_ms) else 0.0
    print(f"[stats-serve] {finished} queries for {args.tenants} tenants over "
          f"{sched.n_elements_ingested:,} ingested elements in {dt:.1f}s "
          f"({finished/dt:.0f} q/s, {sched.n_elements_ingested/dt:,.0f} "
          f"elem/s, query latency p50 {p50:.1f} ms / p99 {p99:.1f} ms, "
          f"resident bank {svc.resident_bytes/1e6:.2f} MB)")


if __name__ == "__main__":
    main()
