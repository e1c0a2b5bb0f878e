"""Batched query plane (port of ``repro/stats/query.py``).

``QueryEngine`` takes a materialized set of per-l sketches and answers a
whole batch of ``(FreqFn, Segment, lane)`` queries in one f64 device pass
over the stacked lane arrays, returning the estimates plus per-query
variance/CI diagnostics.

Bit-identity contract: every answer is bit-identical to the scalar
``estimators.estimate(result, fn, segment)`` loop and to the reference
engine.  The device only executes exactly-rounded IEEE f64 ops (gather,
compare, min, divide, add) — each a separate PyTorch kernel, so nothing is
contracted into a fused multiply-add — while the transcendental pieces
(2-pass Phi, discrete beta tables, f-tables of custom FreqFns) are built on
host with the scalar estimators' numpy code, and the final per-query
reduction is an f64 ``np.sum`` on host over the lane's true sample length.

``query_batch_async`` enqueues a batch's device pass and returns at once (a
``PendingBatch``): its uploads are non-blocking copies from pinned memory
and nothing in it waits for the device, so a caller can enqueue other work
(the serving scheduler's next ingest tick) behind it; ``result()`` copies
the per-key matrix to the host once and reduces it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import estimators, freqfns
from ..core import segments as SEG
from ..core.samplers import SampleResult

# per-query estimator form, selected on host by mirroring the branch
# structure of estimators.estimate:
_PATH_F = 0        # est = f(c)           (tau=inf; discrete lanes via tables)
_PATH_INVPROB = 1  # est = f(w) / Phi(w)  (2-pass inverse probability)
_PATH_CONT = 2     # est = f(c)/d1 + f'(c)/d2   (Thm 5.3, d1=min(1,l tau), d2=tau)

_Z95 = 1.959963984540054  # normal 97.5% quantile


@dataclasses.dataclass(frozen=True)
class Query:
    """One (statistic, segment, lane) request.

    ``l=None`` lets the owner (StreamStatsService.query_batch) pick the lane
    from the statistic; the engine itself requires it resolved.  ``l`` is
    any hashable lane key of the engine's sketch dict (a float cap parameter
    for a service).
    """

    fn: freqfns.FreqFn
    segment: object = None
    l: object | None = None


@dataclasses.dataclass
class BatchResult:
    """Answers + diagnostics for one query batch (arrays indexed by query)."""

    estimates: np.ndarray   # [Q] f64 — bit-identical to the scalar loop
    variances: np.ndarray   # [Q] f64 HT plug-in variance estimates
    stderr: np.ndarray      # [Q] f64 sqrt(variance)
    ci_low: np.ndarray      # [Q] f64 normal-approx 95% lower bound
    ci_high: np.ndarray     # [Q] f64 normal-approx 95% upper bound
    n_keys: np.ndarray      # [Q] i32 sampled keys inside the segment
    lanes: np.ndarray       # [Q] f64 the l each query was answered from
    # degraded-mode provenance (stats.shardtier): a healthy single service
    # answers with the defaults -- coverage 1, nothing stale.  A sharded tier
    # answering from a subset of shards stamps the routed-element coverage
    # fraction, the count of elements routed to shards it could not reach,
    # the degraded flag, and how the answer was produced.
    coverage: float = 1.0         # routed elements reachable / routed total
    staleness_elements: int = 0   # routed elements missing from the answer
    degraded: bool = False        # True iff answered from a partial tier
    mode: str = "sketch"          # "sketch" | "approx" | "exact" | "snapshot"

    def __len__(self) -> int:
        return len(self.estimates)


def _dispatch(counts, valid, phi, segbank, fbank, fpbank, ints, floats, *,
              use_phi: bool, use_tabs: bool):
    """The one device pass: [Q] queries over [L, K] stacked lanes.

    The lane arrays and the segment-mask / coefficient-table banks stay on
    the device between calls, so a batch only ships two small [*, Q]
    index/scalar arrays.  ``use_phi`` is False when no query runs the 2-pass
    inverse-probability path, ``use_tabs`` when every query's statistic is
    device-evaluable (the common all-{cap_T} case).
    """
    lane_idx, path, kind_id, seg_idx, tab_idx = (ints[i] for i in range(5))
    param, d1, d2 = (floats[i][:, None] for i in range(3))
    c = counts[lane_idx]                      # [Q, K] f64 gather
    live = valid[lane_idx] & segbank[seg_idx]  # [Q, K]
    kf, kfp = freqfns.eval_kinds_batched(kind_id[:, None], param, c)
    if use_tabs:
        use_tab = (tab_idx > 0)[:, None]      # bank row 0 == "no table"
        fval = torch.where(use_tab, fbank[tab_idx], kf)
        fpval = torch.where(use_tab, fpbank[tab_idx], kfp)
    else:
        fval, fpval = kf, kfp
    p = path[:, None]
    cont = fval / d1 + fpval / d2
    if use_phi:
        est = torch.where(
            p == _PATH_F, fval,
            torch.where(p == _PATH_INVPROB, fval / phi[lane_idx], cont))
    else:
        est = torch.where(p == _PATH_F, fval, cont)
    return torch.where(live, est, 0.0)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; on a card a non-blocking copy from pinned
    memory, which never waits for the device."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class _Lane:
    """Host-side view of one materialized sketch + its per-lane caches.

    ``key`` is the engine's lane address (the sketch-dict key — a float l,
    or any hashable such as a (tenant, l) tuple); ``l`` is the numeric cap
    parameter reported back in BatchResult.lanes (the dict key when numeric,
    else the sketch's own l)."""

    def __init__(self, key, res: SampleResult):
        self.key = float(key) if isinstance(key, (int, float)) else key
        self.l = (float(key) if isinstance(key, (int, float))
                  else float(res.l))
        self.res = res
        self.n = len(res.keys)
        self.counts = np.asarray(res.counts, np.float64)
        # estimator path, mirroring estimators.estimate's branch order
        if math.isinf(res.tau):
            self.path = _PATH_F
            self.tabulated = False
        elif res.exact_weights:
            self.path = _PATH_INVPROB
            self.tabulated = False
        elif res.kind == "continuous":
            self.path = _PATH_CONT
            self.tabulated = False
        elif res.kind in ("discrete", "distinct", "sh"):
            self.path = _PATH_F
            self.tabulated = True  # per-(lane, fn) beta tables
        else:
            raise ValueError(res.kind)
        # d1/d2 of the Thm 5.3 coefficient form, f64 host scalars so the
        # device divisions reproduce cont.beta exactly.  Always res.l — the
        # dict key addressing this lane may legitimately differ from the
        # sketch's actual cap parameter (ad-hoc engines).
        if self.path == _PATH_CONT:
            self.d1 = min(1.0, float(res.l) * res.tau)
            self.d2 = float(res.tau)
        else:
            self.d1 = self.d2 = 1.0
        # query-independent transcendental pieces (host numpy, shared with
        # the scalar path):
        if self.path == _PATH_INVPROB:
            self.phi = np.asarray(
                estimators._inclusion_prob(res, self.counts), np.float64)
        else:
            self.phi = np.ones(self.n, np.float64)
        self.pincl = estimators.inclusion_per_key(res)

    def seg_mask(self, seg: SEG.Segment) -> np.ndarray:
        return np.ascontiguousarray(seg.mask_np(self.res.keys))

    def fn_tables(self, fn: freqfns.FreqFn) -> tuple[np.ndarray, np.ndarray]:
        """Per-key (f, f') value tables for fns the device can't evaluate
        exactly — and the discrete-spectrum beta tables, where the per-key
        estimate IS a host-built coefficient gathered by count."""
        if self.tabulated:
            vals = estimators.estimate_per_key(self.res, fn)
            return (np.asarray(vals, np.float64), np.zeros(self.n, np.float64))
        return (np.asarray(fn.f(self.counts), np.float64),
                np.asarray(fn.fprime(self.counts), np.float64))


class QueryEngine:
    """Answer batches of (FreqFn, Segment, lane) queries in one dispatch.

    Built from a ``{l: SampleResult}`` dict (the service's materialized
    sketches — 1-pass or reconciled 2-pass — or any ad-hoc collection of
    samples).  The engine is immutable w.r.t. the sketches: rebuild it when
    the underlying sample changes (StreamStatsService does this lazily).
    ``device`` holds the lane arrays and runs the per-key pass.
    """

    def __init__(self, sketches: dict[float, SampleResult], *, device):
        if not sketches:
            raise ValueError("QueryEngine needs at least one sketch lane")
        self.lanes = [_Lane(l, res) for l, res in sketches.items()]
        self._lane_of = {lane.key: i for i, lane in enumerate(self.lanes)}
        self.K = max(1, max(lane.n for lane in self.lanes))
        L = len(self.lanes)
        counts = np.zeros((L, self.K), np.float64)
        valid = np.zeros((L, self.K), bool)
        phi = np.ones((L, self.K), np.float64)
        pincl = np.ones((L, self.K), np.float64)
        for i, lane in enumerate(self.lanes):
            counts[i, : lane.n] = lane.counts
            valid[i, : lane.n] = True
            phi[i, : lane.n] = lane.phi
            pincl[i, : lane.n] = lane.pincl
        self._one_minus_pincl = 1.0 - pincl  # host [L, K], for the var matvec
        self._has_invprob = any(lane.path == _PATH_INVPROB for lane in self.lanes)
        self.device = torch.device(device)
        self._counts = _upload(counts, self.device)
        self._valid = _upload(valid, self.device)
        self._phi = _upload(phi, self.device)
        # device-resident banks of compiled segment masks and coefficient
        # tables, grown on first use and cached across batches: a steady-
        # state batch ships only two [*, Q] vectors to the device
        self._seg_rows: list[np.ndarray] = []
        self._seg_counts: list[int] = []     # sampled keys per bank row
        self._seg_index: dict = {}           # (lane_i, Segment) -> bank row
        self._tab_f_rows = [np.zeros(self.K, np.float64)]   # row 0: no table
        self._tab_fp_rows = [np.zeros(self.K, np.float64)]
        self._tab_index: dict = {}           # (lane_i, fn.cache_key) -> row
        self._banks_dirty = True
        self._segbank_d = self._fbank_d = self._fpbank_d = None
        # growth bounds: a long-lived server fed never-repeating segments
        # must not grow host+device memory forever — crossing a limit resets
        # that bank (and the plans referencing its rows) wholesale; steady
        # workloads never hit it
        self._seg_rows_max = 1024
        self._tab_rows_max = 256
        # plans are pure functions of batch content (bank rows are append-
        # only between resets, so cached row indices never go stale) —
        # repeated production batches skip the per-query resolution loop
        self._plan_cache: dict = {}
        self._plan_cache_max = 512

    def _lane_index(self, l) -> int:
        if l is None:
            if len(self.lanes) == 1:
                return 0
            raise ValueError(
                f"query needs an explicit lane key from {list(self._lane_of)} "
                "(StreamStatsService.query_batch resolves lanes automatically)")
        key = float(l) if isinstance(l, (int, float)) else l
        i = self._lane_of.get(key)
        if i is None:
            raise KeyError(
                f"no sketch lane {l!r}; have {list(self._lane_of)}")
        return i

    def _ensure_bank_capacity(self, n_queries: int) -> None:
        """Reset a bank (wholesale) BEFORE building a plan that could
        overflow it mid-batch — a mid-plan reset would strand row indices
        already assigned to earlier queries of the same batch.  Cached plans
        embed row indices, so every reset also drops the plan cache; the
        current batch then rebuilds from an empty bank (and may exceed the
        soft cap on its own, which the next batch's check claws back)."""
        if len(self._seg_rows) > max(0, self._seg_rows_max - n_queries):
            self._seg_rows, self._seg_counts = [], []
            self._seg_index = {}
            self._plan_cache.clear()
            self._banks_dirty = True
        if len(self._tab_f_rows) > max(1, self._tab_rows_max - n_queries):
            zero = np.zeros(self.K, np.float64)
            self._tab_f_rows, self._tab_fp_rows = [zero], [zero.copy()]
            self._tab_index = {}
            self._plan_cache.clear()
            self._banks_dirty = True

    def _seg_row(self, li: int, seg: SEG.Segment) -> int:
        key = (li, seg)
        idx = self._seg_index.get(key)
        if idx is None:
            lane = self.lanes[li]
            row = np.zeros(self.K, bool)
            row[: lane.n] = lane.seg_mask(seg)
            idx = self._seg_index[key] = len(self._seg_rows)
            self._seg_rows.append(row)
            self._seg_counts.append(int(row.sum()))
            self._banks_dirty = True
        return idx

    def _tab_row(self, li: int, fn: freqfns.FreqFn) -> int:
        key = (li, fn.cache_key)
        idx = self._tab_index.get(key)
        if idx is None:
            lane = self.lanes[li]
            fv, fpv = lane.fn_tables(fn)
            frow = np.zeros(self.K, np.float64)
            fprow = np.zeros(self.K, np.float64)
            frow[: lane.n] = fv
            fprow[: lane.n] = fpv
            idx = self._tab_index[key] = len(self._tab_f_rows)
            self._tab_f_rows.append(frow)
            self._tab_fp_rows.append(fprow)
            self._banks_dirty = True
        return idx

    def _banks(self):
        """Device copies of the mask/table banks (row counts padded to powers
        of two so bank growth reuses a handful of compiled shapes)."""
        if self._banks_dirty:
            S = _next_pow2(max(len(self._seg_rows), 1))
            T = _next_pow2(len(self._tab_f_rows))
            seg = np.zeros((S, self.K), bool)
            if self._seg_rows:
                seg[: len(self._seg_rows)] = np.stack(self._seg_rows)
            f = np.zeros((T, self.K), np.float64)
            fp = np.zeros((T, self.K), np.float64)
            f[: len(self._tab_f_rows)] = np.stack(self._tab_f_rows)
            fp[: len(self._tab_fp_rows)] = np.stack(self._tab_fp_rows)
            self._segbank_d = _upload(seg, self.device)
            self._fbank_d = _upload(f, self.device)
            self._fpbank_d = _upload(fp, self.device)
            self._banks_dirty = False
        return self._segbank_d, self._fbank_d, self._fpbank_d

    def _plan(self, queries):
        """Resolve each query to the dispatch index/scalar vectors (host),
        lane-sorted (the host reductions then work on contiguous row
        slices); ``order`` maps sorted rows back to request order.  Plans
        are cached by batch content."""
        segs = [SEG.as_segment(q.segment) for q in queries]
        cache_key = tuple(
            (q.fn.cache_key, seg, q.l) for q, seg in zip(queries, segs))
        hit = self._plan_cache.get(cache_key)
        if hit is not None:
            return hit
        self._ensure_bank_capacity(len(queries))
        Q = len(queries)
        Qp = _next_pow2(max(Q, 4))  # pad to pow2: few compiled shapes
        ints = np.zeros((5, Qp), np.int32)    # lane, path, kind, seg, tab
        floats = np.zeros((3, Qp), np.float64)  # param, d1, d2
        floats[1:] = 1.0
        for qi, q in enumerate(queries):
            li = self._lane_index(q.l)
            lane = self.lanes[li]
            fn = q.fn
            if lane.path == _PATH_CONT and fn.kind == "distinct":
                # continuity requirement of Thm 5.3 — same swap as the
                # scalar estimator (see estimators.estimate_per_key)
                fn = freqfns.cap(1.0)
            ints[0, qi] = li
            ints[1, qi] = lane.path
            ints[3, qi] = self._seg_row(li, segs[qi])
            floats[1, qi], floats[2, qi] = lane.d1, lane.d2
            if lane.tabulated or not fn.device_exact:
                ints[4, qi] = self._tab_row(li, fn)
            else:
                ints[2, qi] = freqfns.DEVICE_KIND_IDS[fn.kind]
                floats[0, qi] = fn.param
        order = np.argsort(ints[0, :Q], kind="stable").astype(np.int32)
        ints[:, :Q] = ints[:, order]
        floats[:, :Q] = floats[:, order]
        if len(self._plan_cache) >= self._plan_cache_max:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        plan = (ints, floats, order)
        self._plan_cache[cache_key] = plan
        return plan

    def query_batch_async(self, queries) -> "PendingBatch":
        """Enqueue the device pass of a query batch WITHOUT waiting on it;
        the returned handle's ``result()`` does the host reduction.  Nothing
        here synchronises with the device (plans and banks are built on the
        host, uploads are non-blocking), so other work can be enqueued
        behind the batch before anything waits."""
        queries = [q if isinstance(q, Query) else Query(*q) for q in queries]
        if not queries:
            raise ValueError("empty query batch")
        ints, floats, order = self._plan(queries)
        segbank, fbank, fpbank = self._banks()
        use_tabs = bool(ints[4].any())
        per_key = _dispatch(
            self._counts, self._valid, self._phi, segbank, fbank, fpbank,
            _upload(ints.astype(np.int64), self.device), _upload(floats, self.device),
            use_phi=self._has_invprob, use_tabs=use_tabs)
        return PendingBatch(self, per_key, ints, order, len(queries))

    def query_batch(self, queries) -> BatchResult:
        """Answer every query in one device pass + one host reduction.

        ``queries``: iterable of Query or (fn, segment[, l]) tuples.
        """
        return self.query_batch_async(queries).result()

    def _reduce(self, per_key, ints, order, Q) -> BatchResult:
        """The host half of a batch: the scalar-path-identical f64
        reductions of the per-key estimate matrix (host numpy)."""
        lane_idx = ints[0, :Q]
        # the scalar path's reduction: f64 np.sum over the lane's true sample
        # length (identical pairwise grouping => identical bits); rows of one
        # lane reduce together (np.sum(axis=1) per contiguous row == np.sum
        # per row, bit-for-bit).  The HT variance diagnostic rides the same
        # pulled matrix as a per-lane matvec: Var_hat = sum a_x^2 (1 - p_x).
        ests = np.zeros(Q, np.float64)
        var = np.zeros(Q, np.float64)
        lo = 0
        while lo < Q:
            li = int(lane_idx[lo])
            hi = lo + int(np.searchsorted(lane_idx[lo:], li, side="right"))
            n = self.lanes[li].n
            block = per_key[lo:hi, :n]
            ests[order[lo:hi]] = np.sum(block, axis=1)
            var[order[lo:hi]] = np.square(block) @ self._one_minus_pincl[li, :n]
            lo = hi
        stderr = np.sqrt(var)
        inv_nk = np.zeros(Q, np.int32)
        inv_nk[order] = [self._seg_counts[si] for si in ints[3, :Q]]
        lanes = np.zeros(Q, np.float64)
        lanes[order] = [self.lanes[int(li)].l for li in lane_idx]
        return BatchResult(
            estimates=ests,
            variances=var,
            stderr=stderr,
            ci_low=ests - _Z95 * stderr,
            ci_high=ests + _Z95 * stderr,
            n_keys=inv_nk,
            lanes=lanes,
        )



class PendingBatch:
    """A dispatched query batch: the device per-key matrix plus the host plan
    that finishes it.  ``result()`` copies the matrix to the host once and
    runs the f64 reductions; later calls return the cached BatchResult."""

    def __init__(self, engine: QueryEngine, per_key, ints, order, n: int):
        self._engine = engine
        self._per_key = per_key
        self._ints = ints
        self._order = order
        self._n = n
        self._result: BatchResult | None = None

    def __len__(self) -> int:
        return self._n

    def result(self) -> BatchResult:
        if self._result is None:
            self._result = self._engine._reduce(
                self._per_key.cpu().numpy(), self._ints, self._order, self._n)
            self._per_key = None  # drop the device buffer
        return self._result
