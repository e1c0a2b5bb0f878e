"""Multi-objective samples (paper §6): one coordinated sample for all cap_T
(port of ``repro/core/multiobjective.py``).

Coordination (§6.1): each key's randomness is the pair (Hash(x), y_x) with
y_x ~ Exp[w_x] the min over its elements of the Exp[w] score components.  The
SH_l seed for ANY l is then

    seed_l(x) = Hash(x)/l   if y_x <= 1/l   else   y_x .

S_l = bottom-k keys by seed_l; tau_l = (k+1)-smallest seed_l.  The union
S_L = U_l S_l over ALL l in (0, inf) has E|S_L| <= k ln n (Lemma 6.1): a key
is in some S_l iff its Hash rank within the y_x-order prefix is <= k.

Estimation (§6.2, Lemma 6.2): with fixed per-key inclusion thresholds
{tau_l^{-x}}, the combined inclusion probability is

    Phi(w_x) = P_{y~Exp[w_x], h~U[0,1]} [ exists l: y < max(tau_l^{-x}, 1/l)
                                           and  h < l * tau_l^{-x} ]

i.e. the (Exp x Uniform)-measure of a union of axis-aligned rectangles — we
integrate the upper staircase envelope exactly.

``per_key_randomness`` touches every element of the stream: it runs on the
device in f64 torch (a per-key ``scatter_reduce`` min and sum after
``torch.unique``), and ``per_key_randomness_np`` is its plain numpy version
(the reference's).  The rest is host code over the per-key arrays: the
finite-grid union (l in a geometric grid, the deployment recommendation at
the top of §6), the full L = (0, inf) union of the Lemma 6.1 size
experiments, and the §6.2 estimator.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from . import hashing as H
from .freqfns import FreqFn
from .incremental import resolve_device
from .samplers import SALT_ELEM, SALT_KEYBASE


def per_key_randomness_np(keys_stream, weights_stream, salt: int = 0):
    """The coordinated per-key randomness (Hash(x), y_x) and exact weights
    of an unaggregated stream, in host numpy f64: ``(ukeys, hx, y, wx)``,
    ``ukeys`` ascending.  The plain version of ``per_key_randomness``."""
    keys_stream = np.asarray(keys_stream)
    n = len(keys_stream)
    w = np.ones(n) if weights_stream is None else np.asarray(weights_stream, dtype=np.float64)
    eids = np.arange(n, dtype=np.int64)
    u = H.uniform01_np(H.hash_combine_np(eids, np.uint32(SALT_ELEM), np.uint32(salt)))
    v = -np.log1p(-u) / w
    ukeys, inv = np.unique(keys_stream, return_inverse=True)
    y = np.full(len(ukeys), np.inf)
    np.minimum.at(y, inv, v)
    wx = np.zeros(len(ukeys))
    np.add.at(wx, inv, w)
    hx = H.uniform01_np(H.hash_combine_np(ukeys, np.uint32(SALT_KEYBASE), np.uint32(salt)))
    return ukeys, hx, y, wx


def _uniform01_f64(h):
    """uint32 values in int64 lanes -> f64 in (0, 1): (h + 0.5) / 2^32, the
    numpy ``uniform01_np`` bit for bit (2^-32 is exact)."""
    return (h.to(torch.float64) + 0.5) * (1.0 / 4294967296.0)


def per_key_randomness(keys_stream, weights_stream, salt: int = 0, *, device=None):
    """``per_key_randomness_np`` on ``device`` (None: the CUDA card, raising
    without one): f64 element uniforms and Exp[w] components, the per-key
    min and weight sum by ``scatter_reduce``.  Host arrays in and out, with
    the keys' dtype; ``hx`` and the keys equal the plain version's, ``y``
    and ``wx`` agree within f64 rounding (``log1p`` and the order of the
    sums differ between devices)."""
    device = resolve_device(device)
    keys_np = np.asarray(keys_stream)
    n = len(keys_np)
    kd = torch.from_numpy(keys_np.astype(np.int64)).to(device)
    w = (torch.ones(n, dtype=torch.float64, device=device) if weights_stream is None
         else torch.from_numpy(np.asarray(weights_stream, np.float64)).to(device))
    eids = torch.arange(n, dtype=torch.int64, device=device)
    u = _uniform01_f64(H.hash_combine(eids, SALT_ELEM, salt))
    v = -torch.log1p(-u) / w
    ukeys, inv = torch.unique(kd, sorted=True, return_inverse=True)
    y = torch.full(ukeys.shape, math.inf, dtype=torch.float64, device=device)
    y = y.scatter_reduce(0, inv, v, reduce="amin", include_self=True)
    wx = torch.zeros(ukeys.shape, dtype=torch.float64, device=device).index_add_(0, inv, w)
    hx = _uniform01_f64(H.hash_combine(ukeys, SALT_KEYBASE, salt))
    return (ukeys.cpu().numpy().astype(keys_np.dtype), hx.cpu().numpy(),
            y.cpu().numpy(), wx.cpu().numpy())


def seed_for_l(hx, y, l: float):
    return np.where(y <= 1.0 / l, hx / l, y)


def sample_for_l(ukeys, hx, y, k: int, l: float):
    """S_l and tau_l from coordinated randomness."""
    s = seed_for_l(hx, y, l)
    order = np.argsort(s)
    if len(ukeys) <= k:
        return ukeys[order], math.inf
    return ukeys[order[:k]], float(s[order[k]])


def union_sample_grid(ukeys, hx, y, k: int, ls) -> dict:
    """Coordinated union over a finite l-grid; returns {l: (S_l, tau_l)}."""
    return {l: sample_for_l(ukeys, hx, y, k, l) for l in ls}


def union_sample_all_l(ukeys, hx, y, k: int):
    """S_L for L = (0, inf) (Lemma 6.1 construction): x in S_L iff Hash(x)
    ranks <= k within the prefix of keys ordered by increasing y."""
    order = np.argsort(y)
    hs = hx[order]
    member = np.zeros(len(ukeys), dtype=bool)
    heap: list = []  # max-heap of -h of current top-k
    for i in range(len(order)):
        h = hs[i]
        if len(heap) < k:
            heapq.heappush(heap, -h)
            member[order[i]] = True
        elif h < -heap[0]:
            heapq.heapreplace(heap, -h)
            member[order[i]] = True
    return ukeys[member]


def combined_inclusion_prob(w: float, taus: dict[float, float]) -> float:
    """Lemma 6.2 for a finite grid: P[exists l: y < max(tau_l, 1/l) and
    h < l*tau_l] with y ~ Exp[w], h ~ U[0,1].

    Union of rectangles [0, a_l) x [0, b_l), a_l = max(tau_l, 1/l),
    b_l = min(l*tau_l, 1).  Exact integration of the staircase envelope.
    """
    rects = []
    for l, tau in taus.items():
        if math.isinf(tau):
            return 1.0
        rects.append((max(tau, 1.0 / l), min(l * tau, 1.0)))
    # envelope: sort by a ascending; the maximal b among rects with a >= y
    rects.sort()
    a_vals = [r[0] for r in rects]
    # suffix max of b
    b_suffix = [0.0] * (len(rects) + 1)
    for i in range(len(rects) - 1, -1, -1):
        b_suffix[i] = max(b_suffix[i + 1], rects[i][1])
    prob = 0.0
    prev_a = 0.0
    for i in range(len(rects)):
        a = a_vals[i]
        if a > prev_a:
            # y in [prev_a, a): covered rectangles are those with a_l >= a
            seg = (math.exp(-w * prev_a) - math.exp(-w * a)) * b_suffix[i]
            prob += seg
            prev_a = a
    return prob


def estimate_multi(fn: FreqFn, ukeys_sampled, wx_sampled, taus_per_key) -> float:
    """Inverse-probability estimate using the combined Phi (§6.2)."""
    total = 0.0
    for key, w, taus in zip(ukeys_sampled, wx_sampled, taus_per_key):
        p = combined_inclusion_prob(w, taus)
        total += fn(np.array([w]))[0] / p
    return float(total)


def multiobjective_sample(keys_stream, weights_stream, k: int, ls, salt: int = 0, *,
                          device=None):
    """End-to-end: coordinated 2-pass multi-objective sample over an l-grid.

    Returns (union_keys, union_weights, taus_per_key, per_l_samples).
    ``device`` is where ``per_key_randomness`` runs (None: the CUDA card).

    tau_l^{-x} handling (Lemma 6.2 requires per-key thresholds that are
    *independent of x's own randomness*): for EVERY union key x — member of
    S_l or not — tau_l^{-x} is the k-th smallest seed among the OTHER keys.
    x is in S_l exactly when seed_l(x) < tau_l^{-x}, and Phi integrates that
    event's probability, so using the same quantity for members and
    non-members is what makes the estimator unbiased.  (An earlier docstring
    claimed non-members use the (k+1)-smallest overall; that was never what
    the code computed — the k-th smallest of others IS the k-th smallest
    overall when x ranks above it.)
    """
    ukeys, hx, y, wx = per_key_randomness(keys_stream, weights_stream, salt,
                                          device=device)
    per_l = union_sample_grid(ukeys, hx, y, k, ls)
    union_keys = sorted(set().union(*[set(s.tolist()) for s, _ in per_l.values()]))
    union_keys = np.asarray(union_keys, dtype=ukeys.dtype)
    key_to_idx = {x: i for i, x in enumerate(ukeys.tolist())}

    # per-l seeds for exclusion-adjusted thresholds
    seeds = {l: seed_for_l(hx, y, l) for l in ls}
    sorted_seeds = {l: np.sort(s) for l, s in seeds.items()}

    taus_per_key = []
    w_sampled = []
    for x in union_keys.tolist():
        i = key_to_idx[x]
        w_sampled.append(wx[i])
        taus = {}
        for l in ls:
            s_sorted = sorted_seeds[l]
            if len(s_sorted) <= k:
                # k or fewer keys total: every key is sampled and fewer than
                # k OTHER seeds exist, so the exclusion threshold is +inf
                # (the estimator then uses Phi = 1: the sample is the data).
                taus[l] = math.inf
                continue
            own = seeds[l][i]
            # k-th smallest among OTHERS.  With own removed from the sorted
            # array, that is s_sorted[k] when own ranks within the bottom k
            # (own <= s_sorted[k-1]) and s_sorted[k-1] otherwise.  Under an
            # exact tie own == s_sorted[k-1] == s_sorted[k] both branches
            # return the same value, so <= vs < is immaterial (and ties are
            # hash collisions: measure-zero for the continuous seed law).
            if own <= s_sorted[k - 1]:
                taus[l] = float(s_sorted[k])
            else:
                taus[l] = float(s_sorted[k - 1])
        taus_per_key.append(taus)
    return union_keys, np.asarray(w_sampled), taus_per_key, per_l
