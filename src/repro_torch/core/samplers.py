"""Salt lanes, the ``SampleResult`` record, host element ids, and the
sequential sampling oracles: direct transcriptions of the paper's
Algorithms 1-5 (port of ``repro/core/samplers.py``).

The oracles are the *paper-faithful baseline*: per-element cache machines in
numpy / Python dicts / heaps, used as correctness oracles for the chunked
samplers of ``core.vectorized`` and ``core.incremental``.  They run on the
host in both packages, and this copy is bit for bit the reference's.

Randomness is counter-based hashing (core.hashing), so that fixed-threshold
runs are *bit-identical* between the oracle and the vectorized sampler:
the score of element i is a pure function of (salt, key_i, i).

Transcription notes (kept verbatim-faithful except where the camera-ready
pseudocode is garbled):

* Algorithm 5's eviction block prints ``Counters[x] <- -ln(1-r_x)/max(1/l,t*)``
  for surviving keys; the surrounding text ("...with count c_x - l(-ln(1-r_x))",
  §5.2) shows the intended update is ``c_x <- c_x - e_x / max(1/l, tau*)`` with
  e_x = -ln(1-r_x): re-simulating the key's entry as a fresh element of weight
  c_x under the lower threshold.  We implement the text's version; the count
  stays positive by construction (z_x < tau* implies e_x / max(1/l,tau*) < c_x).
* The eviction threshold z_x includes the KeyBase collapse for the race
  branch: race_x = e_x / c_x if e_x / c_x >= 1/l else KeyBase(x) (matching
  the entry rule reversal described in §5.2).
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from . import hashing as H

# Salt lanes, so each use of randomness is an independent hash function.
SALT_ELEM = 0x01
SALT_BUCKET = 0x02
SALT_KEYBASE = 0x03
SALT_EVICT_U = 0x04
SALT_EVICT_R = 0x05
SALT_SHARD = 0x06  # shard/host disambiguation of element ids


@dataclasses.dataclass
class SampleResult:
    keys: np.ndarray          # sampled key ids
    counts: np.ndarray        # c_x (1-pass) or exact w_x (2-pass)
    tau: float                # threshold ((k+1)-smallest seed for fixed-k)
    l: float                  # cap parameter of the scheme
    kind: str                 # "discrete" | "continuous" | "distinct" | "sh"
    exact_weights: bool = False

    def asdict(self) -> dict:
        return dict(zip(self.keys.tolist(), self.counts.tolist()))


def shard_eids_np(shard_no, idx):
    """Element ids for position ``idx`` of shard/host ``shard_no``.

    Hash-derived rather than ``shard_no * n + idx``, which overflows int32
    once P*n > 2^31 and silently aliases element randomness across shards.
    Bit-identical to the device twin ``vectorized.shard_eids`` after the
    uint32 cast both apply.
    """
    idx = np.asarray(idx)
    salt_part = np.broadcast_to(np.uint32(SALT_SHARD), idx.shape)
    shard_part = np.broadcast_to(np.asarray(shard_no, np.uint32), idx.shape)
    return H.hash_combine_np(salt_part, shard_part, idx)


# ---------------------------------------------------------------------------
# Element scoring (vectorized helpers shared by oracle + tests)
# ---------------------------------------------------------------------------


def keybase_np(keys, l: float, salt: int):
    """KeyBase(x) = Hash(x)/l ~ U[0, 1/l]."""
    return H.uniform01_np(H.hash_combine_np(keys, np.uint32(SALT_KEYBASE), np.uint32(salt))) / l


def elem_uniform_np(eids, salt: int):
    return H.uniform01_np(H.hash_combine_np(eids, np.uint32(SALT_ELEM), np.uint32(salt)))


def discrete_score_np(keys, eids, l: int, salt: int):
    """Eq. (6): bucket b = floor(l * rand()); score = Hash(x, b)."""
    u = H.uniform01_np(H.hash_combine_np(eids, np.uint32(SALT_BUCKET), np.uint32(salt)))
    bucket = np.minimum((u * l).astype(np.int64), l - 1)
    return H.uniform01_np(H.hash_combine_np(keys, bucket, np.uint32(salt)))


def distinct_score_np(keys, salt: int):
    """§3.6: ElementScore(h) = Hash(x)."""
    return H.uniform01_np(H.hash_combine_np(keys, np.uint32(salt)))


def sh_score_np(eids, salt: int):
    """§3.7: ElementScore(h) ~ U[0,1] independent per element."""
    return elem_uniform_np(eids, salt)


def continuous_score_np(keys, eids, weights, l: float, salt: int):
    """Eq. (10): v ~ Exp[w]; score = KeyBase(x) if v <= 1/l else v."""
    u = elem_uniform_np(eids, salt)
    v = -np.log1p(-u) / np.asarray(weights, dtype=np.float64)  # v ~ Exp[w]
    kb = keybase_np(keys, l, salt)
    return np.where(v <= 1.0 / l, kb, v)


# ---------------------------------------------------------------------------
# Algorithm 1: 2-pass stream sampling, fixed size k
# ---------------------------------------------------------------------------


def alg1_two_pass(keys, weights, k: int, *, l: float, kind: str = "continuous", salt: int = 0) -> SampleResult:
    """Pass I: bottom-k keys by seed; Pass II: exact weights of sampled keys."""
    keys = np.asarray(keys)
    n = len(keys)
    weights = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    eids = np.arange(n, dtype=np.int64)
    if kind == "continuous":
        scores = continuous_score_np(keys, eids, weights, l, salt)
    elif kind == "discrete":
        scores = discrete_score_np(keys, eids, int(l), salt)
    elif kind == "distinct":
        scores = distinct_score_np(keys, salt)
    elif kind == "sh":
        scores = sh_score_np(eids, salt)
    else:
        raise ValueError(kind)

    # Pass I (faithful cache walk).
    seed: dict = {}
    tau = math.inf
    for i in range(n):
        x = keys[i].item()
        s = scores[i]
        if x in seed:
            seed[x] = min(seed[x], s)
        elif s < tau:
            seed[x] = s
            if len(seed) == k + 1:
                y = max(seed, key=seed.get)
                tau = seed[y]
                del seed[y]
    # Pass II: exact weights for sampled keys.
    sampled = np.array(sorted(seed), dtype=keys.dtype)
    mask = np.isin(keys, sampled)
    w_x = {x: 0.0 for x in sampled.tolist()}
    for i in np.nonzero(mask)[0]:
        w_x[keys[i].item()] += weights[i]
    return SampleResult(
        keys=sampled,
        counts=np.array([w_x[x] for x in sampled.tolist()]),
        tau=tau, l=l, kind=kind, exact_weights=True,
    )


# ---------------------------------------------------------------------------
# Algorithm 2: discrete fixed-threshold stream sampling (uniform weights)
# ---------------------------------------------------------------------------


def alg2_fixed_tau_discrete(keys, tau: float, *, l: int | float, salt: int = 0, kind: str = "discrete") -> SampleResult:
    keys = np.asarray(keys)
    n = len(keys)
    eids = np.arange(n, dtype=np.int64)
    if kind == "discrete":
        scores = discrete_score_np(keys, eids, int(l), salt) if not math.isinf(l) else sh_score_np(eids, salt)
    elif kind == "distinct":
        scores = distinct_score_np(keys, salt)
    elif kind == "sh":
        scores = sh_score_np(eids, salt)
    else:
        raise ValueError(kind)
    counters: dict = {}
    for i in range(n):
        x = keys[i].item()
        if x in counters:
            counters[x] += 1
        elif scores[i] < tau:
            counters[x] = 1
    ks = np.array(sorted(counters), dtype=keys.dtype)
    return SampleResult(
        keys=ks, counts=np.array([counters[x] for x in ks.tolist()], dtype=np.int64),
        tau=tau, l=l, kind=kind,
    )


# ---------------------------------------------------------------------------
# Algorithm 3: discrete fixed-size stream sampling (uniform weights)
# ---------------------------------------------------------------------------


def alg3_fixed_k_discrete(keys, k: int, *, l: int | float, salt: int = 0, kind: str = "discrete") -> SampleResult:
    keys = np.asarray(keys)
    n = len(keys)
    eids = np.arange(n, dtype=np.int64)
    if kind == "discrete" and math.isinf(l):
        kind = "sh"
    if kind == "discrete":
        scores = discrete_score_np(keys, eids, int(l), salt)
    elif kind == "distinct":
        scores = distinct_score_np(keys, salt)
    elif kind == "sh":
        scores = sh_score_np(eids, salt)
    else:
        raise ValueError(kind)

    # Fresh scores for the lazy-seed rescoring walk, keyed by (x, counter).
    rescore_ctr: dict = {}

    def rescore(x: int) -> float:
        c = rescore_ctr.get(x, 0)
        rescore_ctr[x] = c + 1
        eid = np.int64(n + c)  # disjoint from stream eids
        if kind == "discrete":
            return float(discrete_score_np(np.array([x]), np.array([eid]), int(l), salt + 0x10)[0])
        if kind == "distinct":
            return float(distinct_score_np(np.array([x]), salt)[0])  # constant: Hash(x)
        return float(sh_score_np(np.array([eid]), salt + 0x10)[0])

    counters: dict = {}
    seed: dict = {}
    heap: list = []  # max-heap over seeds: (-seed, x)
    tau = 1.0  # supremum of the score range
    for i in range(n):
        x = keys[i].item()
        if x in counters:
            counters[x] += 1
            continue
        s = scores[i]
        if s >= tau:
            continue
        seed[x] = s
        counters[x] = 1
        heapq.heappush(heap, (-s, x))
        while len(counters) > k:
            # pop the key with maximum *current* seed (lazy heap).
            while True:
                negs, y = heapq.heappop(heap)
                if y in counters and seed[y] == -negs:
                    break
            tau = seed[y]
            while counters[y] > 0 and seed[y] >= tau:
                counters[y] -= 1
                seed[y] = rescore(y)
            if counters[y] == 0:
                del counters[y], seed[y]
            else:
                heapq.heappush(heap, (-seed[y], y))
    ks = np.array(sorted(counters), dtype=keys.dtype)
    return SampleResult(
        keys=ks, counts=np.array([counters[x] for x in ks.tolist()], dtype=np.int64),
        tau=tau, l=l, kind=kind,
    )


# ---------------------------------------------------------------------------
# Algorithm 4: continuous SH_l fixed-threshold stream sampling
# ---------------------------------------------------------------------------


def alg4_fixed_tau_continuous(keys, weights, tau: float, *, l: float, salt: int = 0) -> SampleResult:
    keys = np.asarray(keys)
    n = len(keys)
    weights = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    eids = np.arange(n, dtype=np.int64)
    u = elem_uniform_np(eids, salt)
    kb = keybase_np(keys, l, salt)
    r = max(1.0 / l, tau)
    counters: dict = {}
    for i in range(n):
        x = keys[i].item()
        w = weights[i]
        if x in counters:
            counters[x] += w
            continue
        delta = -math.log1p(-u[i]) / r
        if delta < w and (tau * l > 1 or kb[i] < tau):
            counters[x] = w - delta
    ks = np.array(sorted(counters), dtype=keys.dtype)
    return SampleResult(
        keys=ks, counts=np.array([counters[x] for x in ks.tolist()]),
        tau=tau, l=l, kind="continuous",
    )


# ---------------------------------------------------------------------------
# Algorithm 5: continuous SH_l fixed-size stream sampling
# ---------------------------------------------------------------------------


def alg5_fixed_k_continuous(
    keys, weights, k: int, *, l: float, salt: int = 0, batch_evict: int = 1
) -> SampleResult:
    """Fixed-k continuous SH_l with the (optionally batched, §5.2) eviction."""
    keys = np.asarray(keys)
    n = len(keys)
    weights = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    eids = np.arange(n, dtype=np.int64)
    u_elem = elem_uniform_np(eids, salt)
    kb_all = keybase_np(keys, l, salt)
    kb: dict = {}

    counters: dict = {}
    tau = math.inf
    round_ctr = 0

    def evict(delta_evict: int) -> None:
        nonlocal tau, round_ctr
        round_ctr += 1
        items = list(counters.items())
        xs = np.array([x for x, _ in items], dtype=np.int64)
        cs = np.array([c for _, c in items], dtype=np.float64)
        if tau * l > 1:
            ux = H.uniform01_np(H.hash_combine_np(xs, np.uint32(SALT_EVICT_U), np.uint32(round_ctr), np.uint32(salt)))
            rx = H.uniform01_np(H.hash_combine_np(xs, np.uint32(SALT_EVICT_R), np.uint32(round_ctr), np.uint32(salt)))
            ex = -np.log1p(-rx)
            kbs = np.array([kb[x] for x in xs.tolist()])
            race = np.where(ex / cs >= 1.0 / l, ex / cs, kbs)
            seed_part = np.where(np.isinf(tau), np.inf, tau * ux)
            # Score-collapse correction (eq. 10): a (resampled) entry-point
            # score below 1/l means the key's effective seed is KeyBase(x),
            # so its survival threshold via the entry branch is KeyBase(x).
            # The printed z_x = min(tau*u_x, ...) omits this; without it the
            # estimator shows a measurable negative bias once tau crosses 1/l
            # (-2% at k=100 in our Zipf validation; 0 after the fix).
            entry_thresh = np.where(seed_part >= 1.0 / l, seed_part, kbs)
            z = np.minimum(entry_thresh, race)
            order = np.argsort(-z)
            evict_idx = order[:delta_evict]
            tau_star = z[evict_idx[-1]]
            new_rate = max(1.0 / l, tau_star)
            for j in range(len(xs)):
                x = xs[j].item()
                if z[j] >= tau_star:
                    del counters[x]
                else:
                    # survivor count adjustment: only when survival came via
                    # the re-entry race (the entry branch no longer qualifies)
                    if entry_thresh[j] >= tau_star:
                        counters[x] = cs[j] - ex[j] / new_rate
            tau = tau_star
        else:
            kbs = np.array([kb[x] for x in xs.tolist()])
            order = np.argsort(-kbs)
            evict_idx = order[:delta_evict]
            tau_star = kbs[evict_idx[-1]]
            for j in evict_idx:
                del counters[xs[j].item()]
            tau = tau_star

    for i in range(n):
        x = keys[i].item()
        w = weights[i]
        if x in counters:
            counters[x] += w
            continue
        r = max(1.0 / l, 0.0 if math.isinf(tau) else tau)
        if math.isinf(tau):
            r = 1.0 / l  # max(1/l, tau)=inf would make Delta=0; entry is then
            # governed solely by Delta<w vs the 1/l race... but with tau=inf the
            # printed rule max{l^-1, tau} = inf gives Delta = 0: every key
            # enters with full weight, matching SH's warm-up phase.
            delta = 0.0
        else:
            delta = -math.log1p(-u_elem[i]) / r
        if delta < w and ((tau * l > 1 if not math.isinf(tau) else True) or kb_all[i] < tau):
            kb[x] = kb_all[i]
            counters[x] = w - delta
            if len(counters) == k + 1:
                # delta=1 is Algorithm 5 verbatim; delta>1 is the paper's
                # "batch evictions" optimization (§5.2): new tau* is the
                # delta-th largest z_x and all keys with z >= tau* go.
                evict(min(batch_evict, k))
    ks = np.array(sorted(counters), dtype=keys.dtype)
    return SampleResult(
        keys=ks, counts=np.array([counters[x] for x in ks.tolist()]),
        tau=tau, l=l, kind="continuous",
    )
