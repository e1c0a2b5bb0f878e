"""Discrete SH_l spectrum (paper §4): the phi / psi / beta machinery.

Host numpy, copied from ``repro/core/discrete.py`` so the port stands alone.

Element scoring (eq. 6): an element of key x draws a uniform bucket
b ~ U[1..l] and scores Hash(x, b).  Distinct sampling is SH_1, classic SH is
SH_inf.

Estimation (§4.1): sampling acts on the key-frequency histogram m as an
upper-triangular transform  E[o] = Y(phi) m, where

    phi_i = P[the i-th element of a key is the first one counted]
          = tau * sum_j a_{i-1,j} (1-tau)^j (l-j)/l                (paper)

with a_{ij} = P[exactly j distinct buckets used in the first i elements],
computed by the recurrence (eq. 8)

    a_{ij} = a_{i-1,j} * j/l + a_{i-1,j-1} * (l-j+1)/l .

The inverse transform Y(psi) = Y(phi)^{-1} gives the unique unbiased
("admissible", Thm 4.1) coefficient-form estimator

    Qhat(f, H) = sum_{x in S∩H} beta_{c_x},
    beta_i = sum_{j=1..i} psi_j f_{i-j+1} .

Theorem 4.2 guarantees beta >= 0 for monotone non-decreasing f; tests assert
both the closed-form special cases (l=1 distinct: psi = [1/tau]; l=inf SH:
psi = [1/tau, -(1-tau)/tau]) and nonnegativity.

Everything here runs on the host in float64 (estimation is a post-processing
step on O(k)-size samples; the device-side hot path lives in vectorized.py /
kernels/).
"""
from __future__ import annotations

import math

import numpy as np


def phi_vector(l: int | float, tau: float, max_len: int = 200_000, tol: float = 1e-15) -> np.ndarray:
    """phi[i-1] = P[i-th element of a key is first counted], i = 1.. .

    Truncated adaptively once entries fall below ``tol * tau`` (the paper's
    M = O(min(l log l, tau^-1 log tau^-1)) bound); callers treat missing tail
    entries as 0.
    """
    if not (0 < tau <= 1):
        raise ValueError(f"tau must be in (0,1], got {tau}")
    if l == 1:
        return np.array([tau], dtype=np.float64)
    if math.isinf(l):
        # Classic SH: geometric.
        n = min(max_len, max(8, int(math.ceil(-50.0 / math.log1p(-min(tau, 1 - 1e-12))))))
        i = np.arange(1, n + 1, dtype=np.float64)
        return tau * (1.0 - tau) ** (i - 1.0)
    l = int(l)
    # Rolling row of a_{i,j}, j = 0..l.  a_{1,1} = 1.
    a = np.zeros(l + 1, dtype=np.float64)
    a[1] = 1.0
    j = np.arange(l + 1, dtype=np.float64)
    decay = (1.0 - tau) ** j
    fresh = (l - j) / l  # probability next element draws an unused bucket
    phis = [tau]  # phi_1 = tau (first element always uses a fresh bucket)
    for i in range(2, max_len + 1):
        # phi_i from a_{i-1, j}
        phi_i = tau * float(np.sum(a * decay * fresh))
        phis.append(phi_i)
        if phi_i < tol * tau and i > 8:
            break
        # advance a_{i-1} -> a_i  (recurrence (8))
        a_shift = np.zeros_like(a)
        a_shift[1:] = a[:-1]
        a = a * (j / l) + a_shift * ((l - j + 1.0) / l)
    return np.asarray(phis, dtype=np.float64)


def inclusion_prob(w, phi: np.ndarray):
    """Phi_{tau,l}(w) = sum_{j<=w} phi_j  (2-pass inverse-probability weight)."""
    w = np.asarray(w)
    cum = np.concatenate([[0.0], np.cumsum(phi)])
    idx = np.clip(w.astype(np.int64), 0, len(phi))
    return cum[idx]


def psi_vector(phi: np.ndarray, n: int) -> np.ndarray:
    """Invert the upper-triangular transform: psi = first row of Y(phi)^{-1}.

    psi_1 = 1/phi_1 ; psi_i = -(sum_{j<i} phi_{1+i-j} psi_j) / phi_1 .
    """
    phi_full = np.zeros(n + 1, dtype=np.float64)
    m = min(len(phi), n + 1)
    phi_full[:m] = phi[:m]
    psi = np.zeros(n, dtype=np.float64)
    psi[0] = 1.0 / phi_full[0]
    for i in range(2, n + 1):
        # sum_{j=1}^{i-1} phi_{1+i-j} psi_j   (1-indexed)
        s = float(np.dot(phi_full[i - 1 : 0 : -1], psi[: i - 1]))
        psi[i - 1] = -s / phi_full[0]
    return psi


def beta_coefficients(fvals: np.ndarray, psi: np.ndarray) -> np.ndarray:
    """beta_i = sum_{j=1..i} psi_j f_{i-j+1}, i = 1..n  (Thm 4.1).

    ``fvals`` is the table f_0..f_n (f_0 = f(0) = 0 unused);
    returns beta[0..n-1] for counts 1..n.
    """
    n = len(psi)
    f1 = np.asarray(fvals, dtype=np.float64)[1 : n + 1]
    if len(f1) < n:
        f1 = np.pad(f1, (0, n - len(f1)))
    # beta = psi (*) f  restricted: beta_i = sum psi_j f_{i-j+1}
    beta = np.convolve(psi, f1)[:n]
    return beta


def estimator_coefficients(fvals: np.ndarray, l: int | float, tau: float, n: int) -> np.ndarray:
    """End-to-end: coefficients beta_1..beta_n for the 1-pass SH_l estimator."""
    if l == 1:
        # Distinct sampling (eq. 4): beta_i = f_i / tau.
        f1 = np.asarray(fvals, dtype=np.float64)[1 : n + 1]
        return f1 / tau
    if math.isinf(l):
        # Classic SH (eq. 5): beta_i = (f_i - f_{i-1}(1-tau)) / tau.
        f = np.asarray(fvals, dtype=np.float64)
        f1 = f[1 : n + 1]
        f0 = f[0:n]
        return (f1 - f0 * (1.0 - tau)) / tau
    phi = phi_vector(l, tau)
    psi = psi_vector(phi, n)
    return beta_coefficients(fvals, psi)


def estimate(counts: np.ndarray, fvals: np.ndarray, l: int | float, tau: float) -> float:
    """Qhat(f) = sum_x beta_{c_x} over sampled keys with integer counts c_x."""
    counts = np.asarray(counts, dtype=np.int64)
    if len(counts) == 0:
        return 0.0
    n = int(counts.max())
    beta = estimator_coefficients(fvals, l, tau, n)
    return float(np.sum(beta[counts - 1]))
