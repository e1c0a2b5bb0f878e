"""StreamStatsService: frequency-cap statistics over a stream (port of
``repro/stats/service.py``), with the exact multi-host mode.

The service keeps one fixed-k continuous SH_l sketch per configured l plus
each lane's lossless bottom-(k+1) summary, advanced by
``core.incremental.MultiSampler`` — on the CUDA card, through the
hand-written chunksort and capscore_agg kernels — and answers

    service.query_cap(T, segment)  ~=  Q(cap_T, segment)
    service.query_batch([(fn, segment), ...])   # one device pass

through the batched f64 query plane (``stats.query``), bit-identical to
looping the scalar estimators.  State is O(k * |ls|): only the sub-chunk
remainder (< chunk elements) stays on host until the next batch aligns it;
queries finalize the resident sketches lazily (cached until the next
``observe``).

Multi-host contract (as the reference's):

* every host has a distinct ``StatsConfig.host_id`` (same k/ls/chunk/salt),
  so element randomness never aliases across shards while key randomness
  (KeyBase) is shared through the salt;
* ``merge(other)`` (mode="exact", the default) min-merges each lane's
  lossless bottom-(k+1) summary — exact for any split of elements across
  hosts — and also folds the 1-pass fixed-k sketches;
* ``reconcile(keys, weights)`` is the paper's pass II: stream every host's
  shard back through it to accumulate the exact weights of the sampled
  keys; once the whole stream is re-scanned, queries use the 2-pass
  inverse-probability estimators (``exact_weights=True``);
* ``merge(other, mode="approx")`` skips the summaries: cheapest, unbiased
  for key-partitioned shards, biased when keys straddle hosts; exact
  queries become unavailable.

Checkpoints go through ``checkpoint.manager`` in the reference's file
layout, so a service saved by either package restores in the other.

``MultiTenantStats`` is the multi-tenant serving plane: N tenants' l-grids
in one ``core.incremental.TenantBank`` (one stacked step per ingest tick)
and one ``QueryEngine`` over ``(tenant, l)`` lanes that answers a batch
mixing tenants in one device pass.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..checkpoint import manager as ckpt_manager
from ..core import freqfns, incremental
from ..core.samplers import SampleResult
from ..core.segments import EMPTY, normalize_keys
from .query import BatchResult, PendingBatch, Query, QueryEngine

# the paper's guidance (preceding §6.1): a geometric l-grid with ratio
# sqrt(2)^2 = 2 keeps every T within sqrt(2) of a lane in log space
_L_GRID_FACTOR = 0.5 * math.log(2.0)  # log(sqrt(2))


def _nearest_lane(ls, T: float) -> tuple[float, float]:
    """(nearest-in-log lane l, log-space distance) for a cap parameter T."""
    ls = np.asarray(ls, dtype=np.float64)
    dist = np.abs(np.log(ls) - math.log(max(T, 1e-9)))
    j = int(np.argmin(dist))
    return float(ls[j]), float(dist[j])


def _grid_warning(T: float, l: float, dist: float) -> str:
    return (
        f"cap T={T:g} is {math.exp(dist):.2f}x away from the "
        f"nearest configured lane l={l:g} — beyond the paper's "
        "sqrt(2) log-space factor, so the estimate's CV degrades with "
        "the disparity max(T/l, l/T) (Thm 5.4).  Densify StatsConfig.ls "
        "toward a geometric grid of ratio <= 2 over the queried T range "
        "(and extend its ends if T falls outside).  "
        "(warning shown once per service)")


@dataclasses.dataclass
class StatsConfig:
    k: int = 4096                      # sample size per sketch
    ls: Sequence[float] = (1.0, 16.0, 256.0, 4096.0)  # geometric l-grid (§6)
    chunk: int = 2048
    salt: int = 0x5EED
    host_id: int | None = None         # element-id namespace of this host
    # eviction amortization period E: capacity k + E*chunk, eviction every
    # E chunks.  E=1 (default) evicts every chunk.
    evict_every: int = 1


@dataclasses.dataclass
class _LaneSample:
    """Frozen pass-1 outcome of one l lane (the pass-2 exact-weight
    accumulators live stacked on the device, see ``reconcile``)."""

    l: float
    keys: np.ndarray       # sorted sampled keys (<= k)
    tau: float             # (k+1)-smallest seed, inf if everything sampled


class StreamStatsService:
    """Incremental multi-l sketch service.

    A cap_T query is answered from the sketch with l closest to T in
    log-space (the paper's recommendation preceding §6.1).  ``device=None``
    runs on the CUDA card and raises without one; tests pass ``"cpu"``.
    """

    def __init__(self, config: StatsConfig, *, device=None):
        self.config = config
        self._sampler = incremental.MultiSampler(
            tuple(float(l) for l in config.ls), k=config.k,
            chunk=config.chunk, salt=config.salt, host_id=config.host_id,
            evict_every=config.evict_every, device=device)
        self.device = self._sampler.device
        self._results: dict[float, SampleResult] | None = None
        self._engines: dict[bool, QueryEngine] = {}  # query plane, per path
        self._lanes: list[_LaneSample] | None = None  # frozen pass-1 samples
        self._recon_keys = None  # [L, kmax] device sorted sample keys
        self._recon_acc = None   # [L, kmax] device f64 exact-weight accs
        self._recon_n = 0  # elements re-scanned by the current reconcile
        self._recon_discarded = False  # a begun reconcile was invalidated
        self._exact_ok = True  # summaries valid (invalidated by approx merge)
        self._l_grid_warned = False  # pick_l out-of-grid warning (once)
        self._pick_l_cache: dict[float, float] = {}
        # every host whose stream this service has absorbed (exact mode must
        # never merge two streams sharing an element-id namespace)
        self._host_ids: set[int] = (
            set() if config.host_id is None else {config.host_id})

    # -- ingestion ---------------------------------------------------------

    def observe(self, keys, weights=None) -> None:
        """Feed a batch of stream elements (host arrays).  Keys are
        validated by ``normalize_keys`` — never silently wrapped to int32."""
        self._sampler.observe(keys, weights)
        self._results = None
        self._engines.clear()
        self._invalidate_reconcile()

    def _invalidate_reconcile(self) -> None:
        """New elements / merges change the pass-1 sample: any accumulated
        pass-II weights refer to a stale sample and are discarded."""
        if self._lanes is not None:
            self._lanes = None
            self._recon_keys = self._recon_acc = None
            self._recon_discarded = True
            self._engines.pop(True, None)

    @property
    def n_observed(self) -> int:
        return self._sampler.n_observed

    # -- sketch materialization --------------------------------------------

    def sketches(self) -> dict[float, SampleResult]:
        if self._results is None:
            self._results = self._sampler.finalize()
        return self._results

    # -- queries -------------------------------------------------------------

    def pick_l(self, T: float) -> float:
        cached = self._pick_l_cache.get(T)
        if cached is not None:
            return cached
        l, dist = _nearest_lane(self.config.ls, T)
        if dist > _L_GRID_FACTOR + 1e-9 and not self._l_grid_warned:
            self._l_grid_warned = True
            warnings.warn(_grid_warning(T, l, dist), RuntimeWarning,
                          stacklevel=2)
        self._pick_l_cache[T] = l
        return l

    @property
    def _reconcile_complete(self) -> bool:
        """Every observed element has been streamed back through reconcile."""
        return self._lanes is not None and self._recon_n >= self.n_observed

    def _use_exact(self, exact: bool | None) -> bool:
        # auto mode trusts the exact path only once pass II covered the
        # whole stream: a half-reconciled accumulator would report partial
        # sums
        use_exact = exact if exact is not None else self._reconcile_complete
        if use_exact and not self._reconcile_complete:
            raise ValueError(
                f"exact query before reconcile completed: {self._recon_n} "
                f"of {self.n_observed} observed elements re-scanned — "
                "stream every shard through reconcile() first")
        return use_exact

    def _engine(self, exact: bool | None) -> QueryEngine:
        """The query plane over the current sketches of the chosen path
        (lazily built, cached until the underlying sample changes)."""
        use_exact = self._use_exact(exact)
        engine = self._engines.get(use_exact)
        if engine is None:
            sketches = self.exact_sketches() if use_exact else self.sketches()
            engine = self._engines[use_exact] = QueryEngine(sketches,
                                                            device=self.device)
        return engine

    def _resolve_lane(self, q: Query) -> Query:
        if q.l is not None:
            return q
        kind = q.fn.kind
        if kind in ("cap", "threshold"):
            l = self.pick_l(q.fn.param)
        elif kind == "distinct":
            l = self.pick_l(1.0)
        else:  # total / moment / log1p / custom: weight-proportional regime
            l = max(self.config.ls)
        return Query(q.fn, q.segment, l)

    def query_batch(self, queries, *, exact: bool | None = None) -> BatchResult:
        """Answer a whole batch of (FreqFn, segment[, lane]) queries in one
        device pass; unresolved lanes are picked per statistic like the
        scalar wrappers.  Answers arrive with variance/CI diagnostics.

        ``exact=None`` uses the reconciled 2-pass samples once a reconcile
        covered the whole stream, else the resident 1-pass sketches; True /
        False force one path (True raises before reconcile completes)."""
        qs = [q if isinstance(q, Query) else Query(*q) for q in queries]
        engine = self._engine(exact)
        return engine.query_batch([self._resolve_lane(q) for q in qs])

    def query_cap(self, T: float, segment=None, *, exact: bool | None = None) -> float:
        """Estimate Q(cap_T, segment) (a one-query batch)."""
        r = self.query_batch([Query(freqfns.cap(T), segment)], exact=exact)
        return float(r.estimates[0])

    def query_distinct(self, segment=None, *, exact: bool | None = None) -> float:
        r = self.query_batch([Query(freqfns.distinct(), segment)], exact=exact)
        return float(r.estimates[0])

    def query_total(self, segment=None, *, exact: bool | None = None) -> float:
        r = self.query_batch([Query(freqfns.total(), segment)], exact=exact)
        return float(r.estimates[0])

    def campaign_forecast(self, cap_per_user: float, segment=None, *,
                          exact: bool | None = None) -> float:
        """The paper's motivating query: qualifying impressions under a
        per-user frequency cap, for the user segment H."""
        return self.query_cap(cap_per_user, segment, exact=exact)

    def hot_keys(self, top: int) -> np.ndarray:
        """Keys with the largest sampled counts in the largest-l sketch."""
        res = self.sketches()[max(self.config.ls)]
        order = np.argsort(-res.counts)
        return res.keys[order[:top]]

    # -- multi-host merge ----------------------------------------------------

    def merge(self, other: "StreamStatsService", mode: str = "exact") -> None:
        """Absorb another host's state.  Both services must share
        (k, ls, chunk, salt, evict_every).

        mode="exact": also min-merge the lossless per-lane bottom-(k+1)
        summaries — requires distinct ``host_id``s, otherwise element
        randomness aliases and the merged summary is silently biased.  Run
        ``reconcile`` over every shard afterwards to unlock exact queries.

        mode="approx": the 1-pass fixed-k merge only; exact queries become
        unavailable.
        """
        self.merge_many([other], mode=mode)

    def merge_many(self, others, mode: str = "exact") -> None:
        """Absorb any number of other hosts' states in one fold (the same
        validation as ``merge``, across the whole group).  An empty sequence
        is a no-op."""
        others = list(others)
        if not others:
            return
        for other in others:
            if (tuple(other.config.ls) != tuple(self.config.ls)
                    or other.config.k != self.config.k
                    or other.config.salt != self.config.salt
                    or other.config.chunk != self.config.chunk
                    or other.config.evict_every != self.config.evict_every):
                # salt especially: kb/seed/tau from different hash functions
                # would union into a silently biased sketch; evict_every
                # because the lane-wise table merge requires equal capacities
                raise ValueError(
                    "merge requires identical (k, ls, chunk, salt, evict_every) configs")
        if mode not in ("exact", "approx"):
            raise ValueError(f"unknown merge mode {mode!r}")
        if mode == "exact":
            if self.config.host_id is None or any(
                    o.config.host_id is None for o in others):
                raise ValueError(
                    "exact merge requires a host_id on both services: shared "
                    "element-id namespaces alias randomness across shards")
            ids = set(self._host_ids)
            for other in others:
                overlap = ids & other._host_ids
                if overlap:
                    # hosts absorbed earlier count too
                    raise ValueError(
                        "exact merge requires distinct host_ids across ALL "
                        f"absorbed hosts; {sorted(overlap)} appear on both sides")
                ids |= other._host_ids
            if not (self._exact_ok and all(o._exact_ok for o in others)):
                raise ValueError(
                    "exact merge unavailable: a prior mode='approx' merge "
                    "invalidated the lossless summaries")
        self._sampler.absorb_many([o._sampler for o in others], k=self.config.k,
                                  merge_summaries=(mode == "exact"))
        for other in others:
            self._host_ids |= other._host_ids
        if mode == "approx":
            self._exact_ok = False
        self._results = None
        self._engines.clear()
        self._invalidate_reconcile()

    # -- exact second pass (paper pass II) -----------------------------------

    def begin_reconcile(self) -> None:
        """Freeze the pass-1 sample (per-lane bottom-k keys + threshold) and
        reset the exact-weight accumulators.  Called implicitly by the first
        ``reconcile``; must be called explicitly to restart after an
        ``observe``/``merge`` discarded a begun reconcile."""
        if not self._exact_ok:
            raise ValueError(
                "exact pass unavailable after a mode='approx' merge")
        self._recon_discarded = False
        self._recon_n = 0
        self._engines.pop(True, None)
        bk_keys, bk_seeds = self._sampler.bottomk_summaries()
        k = self.config.k
        self._lanes = []
        for j, l in enumerate(self.config.ls):
            keys_j, seeds_j = bk_keys[j], bk_seeds[j]
            valid = keys_j != EMPTY
            kk, ss = keys_j[valid], seeds_j[valid]
            order = np.argsort(ss)
            if len(kk) > k:
                tau = float(ss[order[k]])
                kk = kk[order[:k]]
            else:
                tau = math.inf
            self._lanes.append(_LaneSample(l=float(l), keys=np.sort(kk), tau=tau))
        self._recon_keys, self._recon_acc = incremental.init_pass2(
            [lane.keys for lane in self._lanes], device=self.device)

    def reconcile(self, keys, weights=None) -> None:
        """Accumulate exact weights of the sampled keys from a batch of the
        original stream (pass II).  Stream every shard's elements through
        this (any batch sizes, any order) before exact queries.  All lanes
        advance in one device pass per batch; keys are validated like
        ``observe``'s."""
        if self._lanes is None:
            if self._recon_discarded:
                # observe()/merge() changed the pass-1 sample after a
                # reconcile began: silently re-beginning would drop the
                # weights accumulated so far
                raise ValueError(
                    "reconcile was invalidated by observe()/merge(): the "
                    "accumulated pass-II weights were discarded — call "
                    "begin_reconcile() and re-stream EVERY shard")
            self.begin_reconcile()
        keys = normalize_keys(keys)
        self._recon_acc = incremental.pass2_accumulate(
            self._recon_keys, self._recon_acc, keys, weights)
        self._recon_n += len(keys)
        self._engines.pop(True, None)

    def exact_sketches(self) -> dict[float, SampleResult]:
        """Per-lane 2-pass SampleResults (exact weights) from the reconciled
        accumulators; available only once pass II covered the whole
        stream."""
        if not self._reconcile_complete:
            raise ValueError(
                f"no complete exact sample: {self._recon_n} of "
                f"{self.n_observed} observed elements re-scanned — run "
                "reconcile(keys, weights) over every shard of the stream")
        acc = self._recon_acc.cpu().numpy()
        return {
            lane.l: SampleResult(
                keys=lane.keys, counts=acc[j, : len(lane.keys)].copy(),
                tau=lane.tau, l=lane.l, kind="continuous", exact_weights=True)
            for j, lane in enumerate(self._lanes)
        }

    # -- state ---------------------------------------------------------------

    def state_dict(self) -> dict:
        """O(k * |ls| + chunk) dict of tensors: the sampler's leaves plus the
        summaries' validity flag, named and typed as the reference's."""
        d = self._sampler.state_dict()
        d["exact_ok"] = torch.tensor(self._exact_ok, device=self.device)
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore from this package's or the reference's state dict."""
        d = dict(d)
        exact_ok = d.pop("exact_ok", True)
        if isinstance(exact_ok, torch.Tensor):
            exact_ok = exact_ok.cpu()
        self._sampler.load_state_dict(d)
        # blobs without summaries load with empty ones: exact mode stays off
        self._exact_ok = ("bk_keys" in d) and bool(exact_ok)
        self._results = None
        self._engines.clear()
        self._lanes = None
        self._recon_keys = self._recon_acc = None
        self._recon_n = 0
        self._recon_discarded = False
        # the absorbed host set is not serialized: a restored service knows
        # only its own configured host_id
        self._host_ids = (set() if self.config.host_id is None
                          else {self.config.host_id})

    def save_checkpoint(self, ckpt_dir: str | Path, step: int) -> Path:
        """Commit the service state through ``checkpoint.manager`` (atomic,
        with retention); the reference's service restores it."""
        return ckpt_manager.save(ckpt_dir, step, self.state_dict())

    def restore_checkpoint(self, ckpt_dir: str | Path, step: int | None = None) -> int:
        """Load the latest (or a given) committed step, written by this
        package or the reference's; returns the step."""
        if step is None:
            step = ckpt_manager.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
        self.load_state_dict(ckpt_manager.restore(ckpt_dir, step, self.state_dict()))
        return step


# ---------------------------------------------------------------------------
# Multi-tenant serving plane: one stacked bank, one coalesced query engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantQuery:
    """One (tenant, statistic, segment[, lane]) request against a bank."""

    tenant: int
    fn: freqfns.FreqFn
    segment: object = None
    l: float | None = None


class MultiTenantStats:
    """N independent per-tenant stats services served from ONE device plane.

    Every tenant keeps its own l-grid of fixed-k sketches, all of them in
    one ``TenantBank``: a ``tick`` advances every tenant with a full chunk
    queued in one stacked step, and one ``QueryEngine`` over ``(tenant, l)``
    lane keys answers a query batch that mixes tenants in one device pass.
    Per-tenant answers are bit-identical to ``n_tenants`` standalone
    ``StreamStatsService``s (salt = the tenant's) over the same streams.

    Snapshot semantics: queries are answered from the engine built at the
    last ``refresh()``.  The scheduler (``stats.scheduler``) refreshes at its
    own cadence (``auto_refresh=False``) so the next tick's device work
    overlaps a query batch against the previous snapshot; direct callers
    refresh on demand.  ``device=None`` runs on the CUDA card.
    """

    def __init__(self, config: StatsConfig, *, n_tenants: int, tenant_salts=None,
                 device=None):
        self.config = config
        self.n_tenants = int(n_tenants)
        salts = config.salt if tenant_salts is None else tenant_salts
        self._bank = incremental.TenantBank(
            config.ls, n_tenants=n_tenants, k=config.k, chunk=config.chunk,
            salts=salts, host_id=config.host_id,
            evict_every=config.evict_every, device=device)
        self.device = self._bank.device
        self._engine: QueryEngine | None = None
        self._engine_tenants: set[int] | None = None  # None = all tenants
        self._stale = True
        self._l_grid_warned = False
        self._pick_l_cache: dict[float, float] = {}

    # -- ingestion ---------------------------------------------------------

    def observe(self, tenant: int, keys, weights=None) -> None:
        """Stage stream elements for one tenant (advanced at the next tick)."""
        self._bank.observe(tenant, keys, weights)
        self._stale = True

    def tick(self) -> int:
        """One stacked ingest step (every tenant with a full queued chunk
        advances by one chunk); returns the active-tenant count."""
        n = self._bank.tick()
        if n:
            self._stale = True
        return n

    def drain(self) -> int:
        n = self._bank.drain()
        if n:
            self._stale = True
        return n

    def backlog_chunks(self) -> np.ndarray:
        return self._bank.backlog_chunks()

    def n_observed(self, tenant: int) -> int:
        return self._bank.n_observed(tenant)

    # -- query plane -------------------------------------------------------

    @property
    def stale(self) -> bool:
        """True when elements were observed or ticked since the last refresh."""
        return self._stale or self._engine is None

    @property
    def has_engine(self) -> bool:
        return self._engine is not None

    def refresh(self, tenants=None) -> QueryEngine:
        """(Re)build the query snapshot: one extraction off the device and
        one engine over the (tenant, l) lanes -- the one query-plane point
        that waits for in-flight ingest.

        ``tenants`` restricts the snapshot to a subset (the scheduler passes
        the tenants of the admitted batch): only their rows leave the
        device.  A later query for a tenant outside it widens the snapshot
        (that tenant's lanes then reflect the state at that point)."""
        if tenants is None:
            sketches = {(t, float(l)): res
                        for t, per in enumerate(self._bank.finalize_all())
                        for l, res in per.items()}
            self._engine_tenants = None
        else:
            sub = self._bank.finalize_some(tenants)
            sketches = {(t, float(l)): res
                        for t, per in sub.items() for l, res in per.items()}
            self._engine_tenants = set(sub)
        self._engine = QueryEngine(sketches, device=self.device)
        self._stale = False
        return self._engine

    def _ensure_engine(self, auto_refresh: bool, needed: set[int]) -> QueryEngine:
        if self._engine is None or (auto_refresh and self._stale):
            return self.refresh()
        covered = self._engine_tenants
        if covered is not None and not needed <= covered:
            return self.refresh(tenants=covered | needed)
        return self._engine

    def pick_l(self, T: float) -> float:
        cached = self._pick_l_cache.get(T)
        if cached is not None:
            return cached
        l, dist = _nearest_lane(self.config.ls, T)
        if dist > _L_GRID_FACTOR + 1e-9 and not self._l_grid_warned:
            self._l_grid_warned = True
            warnings.warn(_grid_warning(T, l, dist), RuntimeWarning, stacklevel=2)
        self._pick_l_cache[T] = l
        return l

    def _resolve(self, q: TenantQuery) -> Query:
        if not 0 <= q.tenant < self.n_tenants:
            raise ValueError(f"tenant {q.tenant} out of range [0, {self.n_tenants})")
        l = q.l
        if l is None:
            kind = q.fn.kind
            if kind in ("cap", "threshold"):
                l = self.pick_l(q.fn.param)
            elif kind == "distinct":
                l = self.pick_l(1.0)
            else:  # total / moment / log1p / custom: weight-proportional
                l = max(self.config.ls)
        return Query(q.fn, q.segment, (int(q.tenant), float(l)))

    def resolve_queries(self, requests) -> list[Query]:
        """(tenant, fn, segment[, l]) tuples or TenantQuerys as engine
        queries addressed by lane key (tenant, l)."""
        qs = [r if isinstance(r, TenantQuery) else TenantQuery(*r) for r in requests]
        return [self._resolve(q) for q in qs]

    def query_batch(self, requests, *, auto_refresh: bool = True) -> BatchResult:
        """Answer a batch mixing tenants in one device pass; each request a
        ``TenantQuery`` or a ``(tenant, fn, segment[, l])`` tuple.  Answers
        and diagnostics are bit-identical to each tenant's standalone
        service's."""
        return self.query_batch_async(requests, auto_refresh=auto_refresh).result()

    def query_batch_async(self, requests, *, auto_refresh: bool = True) -> PendingBatch:
        """Enqueue the batch's device pass without waiting for it (see
        ``QueryEngine.query_batch_async``): the scheduler's overlap hook."""
        qs = self.resolve_queries(requests)
        engine = self._ensure_engine(auto_refresh, {q.l[0] for q in qs})
        return engine.query_batch_async(qs)

    def query_cap(self, tenant: int, T: float, segment=None) -> float:
        r = self.query_batch([TenantQuery(tenant, freqfns.cap(T), segment)])
        return float(r.estimates[0])

    def query_distinct(self, tenant: int, segment=None) -> float:
        r = self.query_batch([TenantQuery(tenant, freqfns.distinct(), segment)])
        return float(r.estimates[0])

    def query_total(self, tenant: int, segment=None) -> float:
        r = self.query_batch([TenantQuery(tenant, freqfns.total(), segment)])
        return float(r.estimates[0])

    # -- checkpointing -----------------------------------------------------

    def state_dict(self) -> dict:
        """[T, ...]-stacked flat dict (``TenantBank.state_dict``); one tenant
        slices out through ``tenant_state_dict`` / ``manager.restore_slice``."""
        return self._bank.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self._bank.load_state_dict(d)
        self._engine = None
        self._stale = True

    def tenant_state_dict(self, tenant: int) -> dict:
        """One tenant in ``MultiSampler.state_dict`` form (the leave handoff)."""
        return self._bank.tenant_state_dict(tenant)

    def load_tenant_state_dict(self, tenant: int, d: dict) -> None:
        """Splice one tenant's blob into the bank (the join handoff)."""
        self._bank.load_tenant_state_dict(tenant, d)
        self._engine = None
        self._stale = True

    @property
    def resident_bytes(self) -> int:
        return self._bank.resident_bytes

    def save_checkpoint(self, ckpt_dir: str | Path, step: int) -> Path:
        return ckpt_manager.save(ckpt_dir, step, self.state_dict())

    def restore_checkpoint(self, ckpt_dir: str | Path, step: int | None = None) -> int:
        if step is None:
            step = ckpt_manager.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
        self.load_state_dict(ckpt_manager.restore(ckpt_dir, step, self.state_dict()))
        return step
