"""Unified estimation API over SampleResult objects.

Host numpy, copied from ``repro/core/estimators.py`` so the port stands alone.

Dispatches to the right estimator for the sample's provenance:

* 2-pass samples (exact weights): inverse probability  f(w)/Phi(w)  (eq. 2),
  with Phi from eq. (11) (continuous), §4.1 (discrete), tau^-1 (distinct) or
  1-e^{-w tau} (SH == ppswor, §3.7).
* 1-pass continuous samples: coefficient form  beta(c) = f(c)/min(1,l tau)
  + f'(c)/tau  (Thm 5.3).
* 1-pass discrete samples: coefficient form  beta_i = sum_j psi_j f_{i-j+1}
  (Thm 4.1), including the closed forms for distinct (eq. 4) and SH (eq. 5).

``segment`` is anything ``segments.as_segment`` coerces (the H in Q(f,H)):
a first-class Segment, an id-list, a vectorized predicate, or a boolean
mask aligned with the sample's keys; estimates restrict the sum to sampled
keys inside the segment (per-key estimates of keys outside the sample are
0, §3.5).

The scalar path is deliberately factored as *per-key estimates over the
whole sample, then a masked sum* — exactly the shape of the batched
``stats.query.QueryEngine`` device dispatch — so the engine's answers are
bit-identical to looping this module (same per-key values, same f64
reduction over the same array length).
"""
from __future__ import annotations

import math

import numpy as np

from . import continuous as cont
from . import discrete as disc
from . import segments as SEG
from .freqfns import FreqFn
from .samplers import SampleResult


def _segment_mask(keys: np.ndarray, segment) -> np.ndarray:
    return SEG.as_segment(segment).mask_np(keys)


def _inclusion_prob(result: SampleResult, w: np.ndarray) -> np.ndarray:
    tau, l = result.tau, result.l
    if result.kind == "continuous":
        return cont.inclusion_prob(w, tau, l)
    if result.kind == "distinct":
        return np.full_like(np.asarray(w, dtype=np.float64), min(tau, 1.0))
    if result.kind == "sh":
        # seed ~ Exp[w_x] transformed: P[min of w uniforms < tau] = 1-(1-tau)^w
        return 1.0 - (1.0 - tau) ** np.asarray(w, dtype=np.float64)
    if result.kind == "discrete":
        phi = disc.phi_vector(l, tau)
        return disc.inclusion_prob(np.asarray(w), phi)
    raise ValueError(result.kind)


def estimate(result: SampleResult, fn: FreqFn, segment=None) -> float:
    """Qhat(f, H) from a sample, choosing the right estimator.

    Per-key estimates over the whole sample, then a masked f64 sum — the
    reduction the batched query engine reproduces bit-for-bit.  (This
    replaced a compact-then-sum formulation; segment-restricted answers can
    differ from pre-query-plane releases in the last ulp because the
    pairwise-summation grouping changed.  The invariant maintained going
    forward is engine == this function, exactly.)
    """
    mask = _segment_mask(result.keys, segment)
    if not mask.any():
        return 0.0
    per_key = estimate_per_key(result, fn)
    return float(np.sum(np.where(mask, per_key, 0.0)))


def estimate_per_key(result: SampleResult, fn: FreqFn) -> np.ndarray:
    """Per-key unbiased estimates fhat(w_x) (variance diagnostics, and the
    building block of ``estimate``)."""
    vals = result.counts
    tau, l = result.tau, result.l
    if math.isinf(tau):
        # fewer than k+1 keys ever qualified: the sample IS the data set
        return fn(vals)
    if result.exact_weights:
        return fn(vals) / _inclusion_prob(result, vals)
    if result.kind == "continuous":
        # Thm 5.3 requires f continuous with f(0)=0; the distinct step
        # 1[w>0] violates it (E[beta(c)] = 1 - e^{-w max(1/l,tau)} != 1).
        # For weights >= 1 distinct == cap_1, which is continuous — swap it
        # (the 2-pass inverse-probability path above handles the raw step).
        from .freqfns import cap as _cap

        if fn.name == "distinct":
            fn = _cap(1.0)
        return cont.beta(fn, vals, tau, l)
    if result.kind in ("discrete", "distinct", "sh"):
        eff_l = {"distinct": 1, "sh": math.inf}.get(result.kind, l)
        n = int(np.max(vals)) if len(vals) else 1
        beta = disc.estimator_coefficients(fn.table(n), eff_l, tau, n)
        return beta[vals.astype(np.int64) - 1]
    raise ValueError(result.kind)


def inclusion_per_key(result: SampleResult, clip: float = 1e-12) -> np.ndarray:
    """Plug-in per-key inclusion probabilities p_x for variance diagnostics.

    Exact for 2-pass samples (Phi of the exact weight); for 1-pass samples
    the observed count c_x stands in for w_x — a plug-in heuristic whose
    calibration the Monte-Carlo CI tests check.  tau=inf means everything
    was kept: p = 1 and the variance diagnostic collapses to 0.
    """
    if math.isinf(result.tau):
        return np.ones(len(result.counts), dtype=np.float64)
    p = np.asarray(_inclusion_prob(result, result.counts), dtype=np.float64)
    return np.clip(p, clip, 1.0)


def relative_error(estimate_value: float, truth: float) -> float:
    return abs(estimate_value - truth) / max(abs(truth), 1e-12)
