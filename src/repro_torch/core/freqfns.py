"""Frequency statistics functions f(w) — the query side of Q(f, H) (eq. 1).

Each ``FreqFn`` carries the function and its a.e.-derivative (needed by the
continuous-spectrum estimator, Thm 5.3: beta(c) = f(c)/min(1, l*tau) + f'(c)/tau)
as a ``(kind, param)`` pair.  The host-side callables (``fn.f`` /
``fn.fprime``, float64 numpy) and the batched device evaluation
(``eval_kinds_batched``, used by ``stats.query.QueryEngine`` to evaluate a
whole family {cap_T} as one tensor op) are the *same formulas*, which is
what makes the batched query plane bit-identical to the scalar estimators.

Port of ``repro/core/freqfns.py``: the host registry is the reference's;
``eval_kinds_batched`` is written for torch tensors.

Kinds whose formulas use only exactly-rounded IEEE ops (min, compare,
divide: ``cap``, ``total``, ``distinct``, ``threshold``) are flagged
``DEVICE_EXACT`` and evaluate on device bit-identically to numpy.
Transcendental kinds (``moment``, ``log1p``) and custom ``FreqFn``s are
evaluated on host into per-key coefficient tables instead (device exp/log/pow
differ from numpy in the last ulp), which the engine ships to the device —
so bit-identity with the scalar path holds for every FreqFn.

All standard statistics from the paper are provided:
  * ``cap(T)``      cap_T(w) = min(w, T)        (frequency cap — the headline)
  * ``distinct()``  cap_1 under unit weights    (L0)
  * ``total()``     f(w) = w                    (Sum / L1)
  * ``moment(p)``   f(w) = w**p                 (frequency moments)
  * ``log1p()``     f(w) = log(1+w)             (a smooth concave example)
  * ``threshold(T)``f(w) = 1[w >= T]            (monotone but discontinuous —
                       supported by the discrete estimator; the continuous
                       estimator requires a.e.-differentiability and treats it
                       as a step, exercised in tests for bias behaviour)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import segments as SEG


# ---------------------------------------------------------------------------
# Kind registry: xp-generic f / f' implementations
# ---------------------------------------------------------------------------


def _f_cap(xp, T, w):
    return xp.minimum(w, T)


def _fp_cap(xp, T, w):
    return (w < T).astype(w.dtype)


def _f_total(xp, T, w):
    return w


def _fp_total(xp, T, w):
    return xp.ones_like(w)


def _f_distinct(xp, T, w):
    return (w > 0).astype(w.dtype)


def _f_threshold(xp, T, w):
    return (w >= T).astype(w.dtype)


def _fp_zero(xp, T, w):
    return xp.zeros_like(w)


def _f_moment(xp, p, w):
    return w**p


def _fp_moment(xp, p, w):
    return p * w ** (p - 1)


def _f_log1p(xp, p, w):
    return xp.log1p(w)


def _fp_log1p(xp, p, w):
    return 1.0 / (1.0 + w)


# kind -> (f(xp, param, w), fprime(xp, param, w), device_exact)
KIND_REGISTRY: dict[str, tuple] = {
    "cap": (_f_cap, _fp_cap, True),
    "total": (_f_total, _fp_total, True),
    "distinct": (_f_distinct, _fp_zero, True),
    "threshold": (_f_threshold, _fp_zero, True),
    "moment": (_f_moment, _fp_moment, False),
    "log1p": (_f_log1p, _fp_log1p, False),
}

# stable integer ids for the device-exact kinds (the jitted engine's
# where-chain dispatch); order is part of the compiled dispatch, keep fixed
DEVICE_KIND_IDS = {"cap": 0, "total": 1, "distinct": 2, "threshold": 3}


def eval_kinds_batched(kind_id, param, w):
    """Evaluate a stacked family of device-exact kinds as one tensor op.

    ``kind_id``/``param`` broadcast against ``w`` (typically [Q, 1] against
    [Q, K] f64 counts).  Returns (f(w), f'(w)).  Only exactly-rounded ops
    are used, so numpy, XLA and PyTorch (CPU or CUDA) agree bit-for-bit —
    the foundation of the query plane's bit-identity contract.
    """
    is_cap = kind_id == DEVICE_KIND_IDS["cap"]
    is_total = kind_id == DEVICE_KIND_IDS["total"]
    is_distinct = kind_id == DEVICE_KIND_IDS["distinct"]
    one = torch.ones_like(w)
    zero = torch.zeros_like(w)
    f = torch.where(
        is_cap, torch.minimum(w, param),
        torch.where(is_total, w,
                    torch.where(is_distinct, (w > 0).to(w.dtype),
                                (w >= param).to(w.dtype))))
    fp = torch.where(is_cap, (w < param).to(w.dtype),
                     torch.where(is_total, one, zero))
    return f, fp


@dataclasses.dataclass(frozen=True)
class FreqFn:
    name: str
    f: Callable[[np.ndarray], np.ndarray]
    fprime: Callable[[np.ndarray], np.ndarray]
    kind: str = "custom"      # registry key, or "custom" for opaque callables
    param: float = 0.0        # the kind's parameter (T, p, ...)

    def __call__(self, w):
        return self.f(w)

    def table(self, n: int) -> np.ndarray:
        """f_i = f(i) for i = 0..n (discrete-spectrum coefficient form)."""
        return self.f(np.arange(n + 1, dtype=np.float64))

    @property
    def cache_key(self):
        """Hashable identity for per-(lane, fn) coefficient-table caches.

        Registered kinds key by (kind, param) — every ``cap(8.0)`` hits the
        same cache slot; custom FreqFns key by the (frozen, hashable) object
        itself, which the cache then keeps alive so identity stays valid.
        """
        if self.kind in KIND_REGISTRY:
            return ("kind", self.kind, float(self.param))
        return self

    @property
    def device_exact(self) -> bool:
        return bool(self.kind in KIND_REGISTRY and KIND_REGISTRY[self.kind][2])


def _registered(name: str, kind: str, param: float) -> FreqFn:
    fi, fpi, _ = KIND_REGISTRY[kind]

    def f(w, _fi=fi, _p=param):
        return _fi(np, _p, np.asarray(w, dtype=np.float64))

    def fprime(w, _fpi=fpi, _p=param):
        return _fpi(np, _p, np.asarray(w, dtype=np.float64))

    return FreqFn(name=name, f=f, fprime=fprime, kind=kind, param=float(param))


def cap(T: float) -> FreqFn:
    return _registered(f"cap_{T:g}", "cap", T)


def distinct() -> FreqFn:
    # For unit weights, distinct == cap_1.  Defined directly as 1[w > 0].
    return _registered("distinct", "distinct", 0.0)


def total() -> FreqFn:
    return _registered("sum", "total", 0.0)


def moment(p: float) -> FreqFn:
    return _registered(f"moment_{p:g}", "moment", p)


def log1p() -> FreqFn:
    return _registered("log1p", "log1p", 0.0)


def threshold(T: float) -> FreqFn:
    return _registered(f"thresh_{T:g}", "threshold", T)


def exact_statistic(fn: FreqFn, weights: np.ndarray, segment=None,
                    keys: np.ndarray | None = None) -> float:
    """Ground-truth Q(f, H) from the aggregated view (for tests/benchmarks).

    ``segment`` accepts everything ``estimators.estimate`` accepts — a
    Segment, an id-list, a predicate, or a positional boolean mask over
    ``weights`` (the historical convention) — via ``segments.as_segment``.
    Key-based segments (IdSet / Predicate / HashBucket) need the aligned
    ``keys`` array of the aggregated view.
    """
    w = np.asarray(weights, dtype=np.float64)
    seg = SEG.as_segment(segment)
    if isinstance(seg, SEG.AllKeys):
        return float(np.sum(fn(w)))
    if isinstance(seg, SEG.Mask):
        mask = seg.mask_np(w)  # positional: aligned with weights
    else:
        if keys is None:
            raise ValueError(
                f"segment {seg.describe()} selects by key id: pass the "
                "aligned keys= array of the aggregated view")
        mask = seg.mask_np(np.asarray(keys))
    return float(np.sum(np.where(mask, fn(w), 0.0)))
