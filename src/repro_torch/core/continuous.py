"""Continuous SH_l spectrum (paper §5): scoring, inclusion, count law, estimator.

Host numpy, copied from ``repro/core/continuous.py`` so the port stands alone.

Element scoring (eq. 10), for element h = (x, w):

    v ~ Exp[w];  ElementScore(h) = KeyBase(x) if v <= 1/l else v,
    KeyBase(x) = Hash(x)/l ~ U[0, 1/l].

Seed law (Lemma 5.1):  seed(x) ~ U[0,1/l] w.p. 1-e^{-w_x/l}, else 1/l+Exp[w_x].

Inclusion probability (eq. 11):

    Phi_{tau,l}(w) = (1 - e^{-w max(1/l, tau)}) * min(1, tau*l).

1-pass count law (Thm 5.2):  c_x ~ max{0, w_x - phi},
    phi with density  tau * exp(-y * max(1/l, tau))  on  y in [0, w_x].

Estimator (Thm 5.3):  beta(c) = f(c)/min(1, l*tau) + f'(c)/tau.

"""
from __future__ import annotations

import numpy as np

from .freqfns import FreqFn


def rate(tau: float, l: float):
    """The count-law / entry rate max(1/l, tau)."""
    return max(1.0 / l, tau)


def inclusion_prob(w, tau: float, l: float):
    """Phi_{tau,l}(w)  (eq. 11); works for scalar or array w (numpy)."""
    w = np.asarray(w, dtype=np.float64)
    return (1.0 - np.exp(-w * max(1.0 / l, tau))) * min(1.0, tau * l)


def beta(fn: FreqFn, c, tau: float, l: float):
    """Continuous-spectrum estimation coefficients (eq. 13)."""
    c = np.asarray(c, dtype=np.float64)
    return fn.f(c) / min(1.0, l * tau) + fn.fprime(c) / tau


def estimate(fn: FreqFn, counts, tau: float, l: float, segment=None) -> float:
    """Qhat(f,H) = sum_{x in S∩H} beta(c_x)  (eq. 12)."""
    counts = np.asarray(counts, dtype=np.float64)
    if segment is not None:
        counts = counts[np.asarray(segment)]
    if counts.size == 0:
        return 0.0
    return float(np.sum(beta(fn, counts, tau, l)))


def estimate_two_pass(fn: FreqFn, weights, tau: float, l: float, segment=None) -> float:
    """2-pass inverse-probability estimator: sum f(w_x)/Phi(w_x)  (eq. 2)."""
    w = np.asarray(weights, dtype=np.float64)
    if segment is not None:
        w = w[np.asarray(segment)]
    if w.size == 0:
        return 0.0
    return float(np.sum(fn.f(w) / inclusion_prob(w, tau, l)))


# -- count law (Thm 5.2) -----------------------------------------------------


def count_zero_prob(w, tau: float, l: float):
    """P[c_x = 0] = 1 - Phi_{tau,l}(w): the key is never sampled."""
    return 1.0 - inclusion_prob(w, tau, l)


def conditional_count(w, tau: float, l: float, u):
    """Sample c_x | x in S: c = w - phi, phi ~ TruncExp(rate) on [0, w).

    Inverse-CDF with uniform(s) u: phi = -log(1 - u (1 - e^{-r w})) / r.
    Used by the vectorized fixed-k sampler's *distributional* count
    realization and by the statistical tests against Algorithm 5.
    """
    w = np.asarray(w, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    r = max(1.0 / l, tau)
    phi = -np.log1p(-u * (1.0 - np.exp(-r * w))) / r
    return w - phi


def count_density(y, w, tau: float, l: float):
    """Density of c_x at c = y in (0, w): tau * exp(-(w - y) * rate)."""
    y = np.asarray(y, dtype=np.float64)
    r = max(1.0 / l, tau)
    return np.where((y > 0) & (y < w), tau * np.exp(-(w - y) * r), 0.0)


# -- CV bounds (Thms 5.1 / 5.4) for validation -------------------------------

_E = np.e


def cv_bound_two_pass(T: float, l: float, q: float, k: int) -> float:
    """Thm 5.1: CV <= sqrt( e/(e-1) * max(T/l, l/T) / (q (k-1)) )."""
    disparity = max(T / l, l / T)
    return float(np.sqrt(_E / (_E - 1.0) * disparity / (q * (k - 1))))


def cv_bound_one_pass(T: float, l: float, q: float, k: int) -> float:
    """Thm 5.4 upper bound: sqrt( e/(e-1) (1 + max(l/T, T/l)) / (q (k-1)) )."""
    disparity = max(T / l, l / T)
    return float(np.sqrt(_E / (_E - 1.0) * (1.0 + disparity) / (q * (k - 1))))
