"""StreamStatsService: frequency-cap statistics over a stream (port of
``repro/stats/service.py``, single host).

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

Not ported yet: multi-host ``merge``/``merge_many``, the exact second pass
(``reconcile``/``exact_sketches``), checkpoint files and
``MultiTenantStats``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Sequence

import numpy as np
import torch

from ..core import freqfns, incremental
from ..core.samplers import SampleResult
from .query import BatchResult, Query, QueryEngine

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
        self._engine_cache: QueryEngine | None = None
        self._exact_ok = True  # summaries valid (kept for the state format)
        self._l_grid_warned = False  # pick_l out-of-grid warning (once)
        self._pick_l_cache: dict[float, float] = {}

    # -- ingestion ---------------------------------------------------------

    def observe(self, keys, weights=None) -> None:
        """Feed a batch of stream elements (host arrays).  Keys are
        validated by ``normalize_keys`` — never silently wrapped to int32."""
        self._sampler.observe(keys, weights)
        self._results = None
        self._engine_cache = None

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

    def _engine(self) -> QueryEngine:
        """The query plane over the current sketches (lazily built, cached
        until the underlying sample changes)."""
        if self._engine_cache is None:
            self._engine_cache = QueryEngine(self.sketches(), device=self.device)
        return self._engine_cache

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

    def query_batch(self, queries) -> BatchResult:
        """Answer a whole batch of (FreqFn, segment[, lane]) queries in one
        device pass; unresolved lanes are picked per statistic like the
        scalar wrappers.  Answers arrive with variance/CI diagnostics."""
        qs = [q if isinstance(q, Query) else Query(*q) for q in queries]
        return self._engine().query_batch([self._resolve_lane(q) for q in qs])

    def query_cap(self, T: float, segment=None) -> float:
        """Estimate Q(cap_T, segment) (a one-query batch)."""
        r = self.query_batch([Query(freqfns.cap(T), segment)])
        return float(r.estimates[0])

    def query_distinct(self, segment=None) -> float:
        r = self.query_batch([Query(freqfns.distinct(), segment)])
        return float(r.estimates[0])

    def query_total(self, segment=None) -> float:
        r = self.query_batch([Query(freqfns.total(), segment)])
        return float(r.estimates[0])

    def campaign_forecast(self, cap_per_user: float, segment=None) -> float:
        """The paper's motivating query: qualifying impressions under a
        per-user frequency cap, for the user segment H."""
        return self.query_cap(cap_per_user, segment)

    def hot_keys(self, top: int) -> np.ndarray:
        """Keys with the largest sampled counts in the largest-l sketch."""
        res = self.sketches()[max(self.config.ls)]
        order = np.argsort(-res.counts)
        return res.keys[order[:top]]

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
        self._engine_cache = None
