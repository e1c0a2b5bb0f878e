#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the port from ``src/repro_torch/
             kernels/csrc`` with nvcc (one process per source, in parallel).
2. kernels — hold each kernel against its plain PyTorch version on the card
             (chunksort: exact on ragged sizes, ties, EMPTY keys;
             capscore_agg: entered/kb_min/min_score exact, sums rtol 1e-5 on
             key-sorted Zipf chunks, C=2048, L=4 and L=8; capscore_multi and
             capscore: every output bit-identical on ragged N, L = 1, 4, 8,
             EMPTY keys, non-unit weights and taus mixing inf, tau*l > 1 and
             tau*l < 1) and time kernel, plain version and, for chunksort,
             ``torch.sort(stable=True)``.
3. main    — ``StreamStatsService(StatsConfig())`` with the service defaults
             (k=4096, ls=(1,16,256,4096), chunk=2048) observes 2^24 Zipf(1.2)
             keys over 2^22 ids in batches of 2^20, then answers one
             query_batch of cap_T, distinct and total over all keys and one
             HashBucket; every estimate must lie within 5 stderr of the exact
             statistic, and the launch counts, reset just before, must show
             that every chunk step went through both kernels.
4. state   — state_dict() mid-stream, loaded into a fresh service; both take
             the same rest of the stream and must agree exactly.
5. profile — ``torch.profiler`` over 64 chunk steps of a warm service:
             device time per kernel, launches per step, device busy share.
6. distributed two-pass — the same 2^24-element stream in 4 contiguous
             shards, one per rank; 4 ranks on the one card
             (``torch.multiprocessing.spawn``, gloo: NCCL refuses two ranks
             on one GPU).  ``make_distributed_two_pass_multi`` with the tree
             and the all-gather merge (bit-identical), and
             ``make_distributed_two_pass`` at l=16 (equal to that lane);
             per rank a ``StreamStatsService(host_id=rank)`` over its shard,
             whose states rank 0 merges exactly (``merge_many``), reconciles
             over all four shards and queries: the merged summaries equal
             the program's, both paths' pass-II weights equal the exact
             counts, every exact estimate lies within 5 stderr, and
             ``capscore_multi`` / ``capscore`` launched once per chunk step
             per rank.

The results and the profile are also written as JSON to ``chiprun_out/``
in the checkout (git-ignored).

It imports nothing of JAX or of the reference package ``repro``.  It exits
non-zero without a CUDA device, and when run without the rest of the repo.
The card's name and power limit (``nvidia-smi``) come two lines before the
last, the ``kernels`` JSON on the line before the last, and the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"
PROFILE_STEPS = 64

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the
# non-tensor-core f32 rate, the nearest listed rate for the scalar ALU work
# of these kernels
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SALT = 0x5EED
EMPTY = 2**31 - 1


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` per call between CUDA events (one stream,
    back-to-back launches, after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_keys(rng, n: int, alpha: float, n_keys: int):
    """Zipf(alpha) keys truncated to [0, n_keys): the paper's §7 generator
    (``repro/data/streams.py``)."""
    return (rng.zipf(alpha, size=n) % n_keys).astype("int64")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_chunksort(device, rng) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.chunksort import ops

    cases = []
    for n in (1, 7, 2047, 2048, 2049, 65536):
        cases.append(("random", rng.integers(0, max(2, n // 3), n)))
    cases.append(("ties", rng.integers(0, 3, 4096)))
    mix = rng.integers(-20, 50, 2049)
    mix[rng.random(2049) < 0.3] = EMPTY
    cases.append(("empty_mix", mix))
    cases.append(("all_empty", np.full(4097, EMPTY)))
    # the main path's shape: one 2048-key Zipf chunk (no padding)
    chunk = zipf_keys(rng, 2048, 1.2, 1 << 22)
    cases.append(("zipf_chunk", chunk))
    for name, keys in cases:
        k = torch.from_numpy(keys.astype(np.int32)).to(device)
        got = ops.sort_with_perm_cuda(k)
        want = ops.sort_with_perm_ref(k)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"chunksort differs from its plain version: {name} n={len(keys)}")
    log(f"chunksort: bit-identical to torch.sort(stable=True) on {len(cases)} cases")

    keys = torch.from_numpy(chunk.astype(np.int32)).to(device)
    n = keys.shape[0]
    ms = cuda_ms(lambda: ops.sort_with_perm_cuda(keys))
    plain = cuda_ms(lambda: ops.sort_with_perm_ref(keys))
    library = cuda_ms(lambda: torch.sort(keys, stable=True))
    # bytes: read keys once, write ks (int32) and perm (int64); operations:
    # the bitonic network's compare-exchanges at the padded power of two
    P = 1 << max(0, n - 1).bit_length()
    lg = P.bit_length() - 1
    b, by = bound_ms(4 * n + 4 * n + 8 * n, (P // 2) * lg * (lg + 1) // 2 * 4)
    log(f"chunksort n={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"torch.sort {library:.4f} ms, bound {b:.6f} ms ({by})")
    return {"name": "chunksort", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunksort.cu",
            "replaces": "src/repro/kernels/chunksort/chunksort.py:135",
            "launches": None, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": library}


def _agg_inputs(device, rng, C: int, L: int):
    import numpy as np
    import torch
    from repro_torch.core.segments import chunk_order

    keys = zipf_keys(rng, C, 1.2, 1 << 22).astype(np.int32)
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = np.ones(C, np.float32)
    ws[: C // 4] = rng.random(C // 4).astype(np.float32) * 3 + 0.05
    order = chunk_order(*(torch.from_numpy(a).to(device) for a in (keys, eids, ws)))
    ls = np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0][:L], np.float32)
    # tau = inf, tau*l > 1 and tau*l < 1 lanes
    taus = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2][:L], np.float32)
    return (order.ks, order.eids, order.ws, order.seg,
            torch.from_numpy(ls).to(device), torch.from_numpy(taus).to(device), SALT)


def _max_abs_err(got, want) -> float:
    import torch

    err = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        same = g == w  # inf == inf
        d = torch.where(same, torch.zeros_like(g), (g - w).abs())
        err = max(err, float(d.max()))
    return err


def check_capscore_agg(device, rng) -> dict:
    import torch
    from repro_torch.kernels.capscore import ops

    err = 0.0
    for L in (4, 8):
        for rep in range(3):
            args = _agg_inputs(device, rng, 2048, L)
            got = ops.capscore_agg_cuda(*args)
            want = ops.capscore_agg_ref(*args)
            torch.cuda.synchronize()
            for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
                if not torch.equal(got[i], want[i]):
                    raise AssertionError(f"capscore_agg {name} differs from the plain "
                                         f"version (L={L}, rep {rep})")
            for i, name in ((0, "w_total"), (2, "contrib")):
                if not torch.allclose(got[i], want[i], rtol=1e-5, atol=0):
                    raise AssertionError(f"capscore_agg {name} beyond rtol 1e-5 (L={L})")
            err = max(err, _max_abs_err(got, want))
    log(f"capscore_agg: entered/kb_min/min_score exact, sums within rtol 1e-5 "
        f"(C=2048, L=4 and 8); max abs err {err:.3e}")

    args = _agg_inputs(device, rng, 2048, 4)  # the main path's shape
    C, L = args[0].shape[0], args[4].shape[0]
    ms = cuda_ms(lambda: ops.capscore_agg_cuda(*args))
    plain = cuda_ms(lambda: ops.capscore_agg_ref(*args))
    # bytes: ks/eids/ws/seg once (16 B/element), ls/taus, and the outputs
    # (w_total f32, then entered u8 + three f32 columns per lane);
    # operations: ~40 integer ops for the element hash, ~30 for log1p and
    # the divisions, ~10 per lane
    n_bytes = 16 * C + 8 * L + 4 * C + 13 * L * C
    b, by = bound_ms(n_bytes, C * (70 + 10 * L))
    log(f"capscore_agg C={C} L={L}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    return {"name": "capscore_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/capscore_agg.cu",
            "replaces": "src/repro/kernels/capscore/capscore.py:466",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def _score_inputs(device, rng, N: int, L: int):
    """Unsorted elements (5% EMPTY keys, a quarter non-unit weights) and
    lanes mixing tau = inf, tau*l > 1 and tau*l < 1."""
    import numpy as np
    import torch

    keys = zipf_keys(rng, N, 1.2, 1 << 22).astype(np.int32)
    keys[rng.random(N) < 0.05] = EMPTY
    eids = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    ws = np.ones(N, np.float32)
    ws[: N // 4] = rng.random(N // 4).astype(np.float32) * 3 + 0.05
    ls = np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.3, 64.0, 1024.0, 0.7],
                            np.float32), L)
    taus = np.resize(np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2],
                              np.float32), L)
    return ([torch.from_numpy(a).to(device) for a in (keys, eids, ws)],
            torch.from_numpy(ls).to(device), torch.from_numpy(taus).to(device))


def check_capscore_multi(device, rng) -> dict:
    import torch
    from repro_torch.kernels.capscore import ops

    n_cases, err = 0, 0.0
    for N in (1, 7, 2047, 2048, 2049, 65536):
        for L in (1, 4, 8):
            elems, ls, taus = _score_inputs(device, rng, N, L)
            got = ops.capscore_multi_cuda(*elems, ls, taus, SALT)
            want = ops.capscore_multi_ref(*elems, ls, taus, SALT)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("score", "delta", "entry", "kb")):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"capscore_multi {name} differs from the plain "
                                         f"version (N={N}, L={L})")
            err = max(err, _max_abs_err(got, want))
            n_cases += 1
    log(f"capscore_multi: every output bit-identical to the plain version on "
        f"{n_cases} cases (N in 1..65536, L in 1, 4, 8)")
    # the distributed pass I's shape: one chunk of the default config
    elems, ls, taus = _score_inputs(device, rng, 2048, 4)
    N, L = 2048, 4
    ms = cuda_ms(lambda: ops.capscore_multi_cuda(*elems, ls, taus, SALT))
    plain = cuda_ms(lambda: ops.capscore_multi_ref(*elems, ls, taus, SALT))
    # bytes: keys/eids/weights once (12 B/element), ls/taus, and four [L, N]
    # outputs of 4 B; operations: ~40 integer ops per element hash (two),
    # ~30 for log1p and the divisions, ~10 per lane
    b, by = bound_ms(12 * N + 8 * L + 16 * L * N, N * (110 + 10 * L))
    log(f"capscore_multi N={N} L={L}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    return {"name": "capscore_multi", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/capscore.cu",
            "replaces": "src/repro/kernels/capscore/capscore.py:270",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def check_capscore(device, rng) -> dict:
    import torch
    from repro_torch.kernels.capscore import ops

    lanes = ((1.0, float("inf")), (16.0, 0.5), (256.0, 1e-3), (3.3, 0.9), (0.7, 0.2))
    n_cases, err = 0, 0.0
    for N in (1, 7, 2047, 2048, 2049, 65536):
        elems, _, _ = _score_inputs(device, rng, N, 1)
        for l, tau in lanes:
            got = ops.capscore_cuda(*elems, l, tau, SALT)
            want = ops.capscore_ref(*elems, l, tau, SALT)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("score", "delta", "entry")):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"capscore {name} differs from the plain "
                                         f"version (N={N}, l={l}, tau={tau})")
            err = max(err, _max_abs_err(got, want))
            n_cases += 1
    log(f"capscore: every output bit-identical to the plain version on {n_cases} "
        "cases")
    elems, _, _ = _score_inputs(device, rng, 2048, 1)
    N = 2048
    ms = cuda_ms(lambda: ops.capscore_cuda(*elems, 16.0, float("inf"), SALT))
    plain = cuda_ms(lambda: ops.capscore_ref(*elems, 16.0, float("inf"), SALT))
    b, by = bound_ms(12 * N + 12 * N, N * 120)
    log(f"capscore N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    return {"name": "capscore", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/capscore.cu",
            "replaces": "src/repro/kernels/capscore/capscore.py:166",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None}


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

T_GRID = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 1000.0)


def _queries(segments):
    from repro_torch.core import freqfns
    from repro_torch.stats.query import Query

    qs = []
    for seg in segments:
        qs += [Query(freqfns.cap(T), seg) for T in T_GRID]
        qs += [Query(freqfns.distinct(), seg), Query(freqfns.total(), seg)]
    return qs


def run_main_path(seed: int, n: int, batch: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import freqfns, segments
    from repro_torch.kernels.capscore import ops as cops
    from repro_torch.kernels.chunksort import ops as sops
    from repro_torch.stats.service import StatsConfig, StreamStatsService

    n_ids = 1 << 22
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    keys = zipf_keys(rng, n, 1.2, n_ids)
    log(f"stream: {n} Zipf(1.2) keys over {n_ids} ids in {time.perf_counter() - t0:.1f} s")
    segs = [segments.AllKeys(), segments.HashBucket(8, 3, salt=7)]
    queries = _queries(segs)

    torch.cuda.reset_peak_memory_stats()
    svc = StreamStatsService(StatsConfig())
    cfg = svc.config
    sops.sort_with_perm_cuda.launches = 0
    cops.capscore_agg_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        svc.observe(keys[lo:lo + batch])
    torch.cuda.synchronize()
    t_obs = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.sketches()
    t_fin = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = svc.query_batch(queries)
    t_q_first = time.perf_counter() - t0
    launches = {"chunksort": sops.sort_with_perm_cuda.launches,
                "capscore_agg": cops.capscore_agg_cuda.launches}
    steps = -(-n // cfg.chunk)
    log(f"launches on the main path: {launches}; chunk steps {steps}")
    if launches["capscore_agg"] != steps:
        raise AssertionError(f"capscore_agg launched {launches['capscore_agg']} "
                             f"times for {steps} chunk steps")
    if launches["chunksort"] < steps:
        raise AssertionError(f"chunksort launched {launches['chunksort']} times "
                             f"for {steps} chunk steps")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        svc.query_batch(queries)
    t_q = (time.perf_counter() - t0) / reps

    ukeys, counts = np.unique(keys, return_counts=True)
    worst = 0.0
    for i, q in enumerate(queries):
        exact = freqfns.exact_statistic(q.fn, counts, q.segment, keys=ukeys)
        est, se = float(res.estimates[i]), float(res.stderr[i])
        if not (np.isfinite(est) and np.isfinite(se)):
            raise AssertionError(f"{q.fn.name} {q.segment.describe()}: non-finite {est} {se}")
        z = abs(est - exact) / se if se > 0 else (0.0 if est == exact else np.inf)
        worst = max(worst, z)
        log(f"  {q.fn.name:>9} {q.segment.describe():>10} l={res.lanes[i]:g}: "
            f"est {est:.6g} exact {exact:.6g} stderr {se:.4g} |z| {z:.2f}")
        if z > 5.0:
            raise AssertionError(f"{q.fn.name} on {q.segment.describe()}: estimate "
                                 f"{est} is {z:.2f} stderr from exact {exact}")
    out = {"elements": n, "chunk_steps": steps, "observe_s": t_obs,
           "elements_per_s": n / t_obs, "chunk_step_ms": t_obs / steps * 1e3,
           "finalize_ms": t_fin * 1e3, "query_batch_first_ms": t_q_first * 1e3,
           "query_batch_ms": t_q * 1e3, "n_queries": len(queries),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "worst_abs_z": worst, "launches": launches}
    log(f"main path: {out['elements_per_s']:.4g} elements/s, "
        f"{out['chunk_step_ms']:.4f} ms per chunk step, finalize {out['finalize_ms']:.2f} ms, "
        f"query batch of {len(queries)} {out['query_batch_ms']:.3f} ms "
        f"(first {out['query_batch_first_ms']:.1f} ms), "
        f"max_memory_allocated {out['max_memory_allocated']} B, worst |z| {worst:.2f}")
    return out


def run_state_round_trip(seed: int, n: int) -> None:
    import numpy as np
    from repro_torch.core import segments
    from repro_torch.stats.service import StatsConfig, StreamStatsService

    rng = np.random.default_rng(seed + 1)
    keys = zipf_keys(rng, n, 1.2, 1 << 22)
    cut = n // 2 + 777  # mid-chunk: the remainder buffer travels too
    a = StreamStatsService(StatsConfig())
    a.observe(keys[:cut])
    b = StreamStatsService(StatsConfig())
    b.load_state_dict(a.state_dict())
    for svc in (a, b):
        svc.observe(keys[cut:])
    sa, sb = a.sketches(), b.sketches()
    for l in sa:
        if not (np.array_equal(sa[l].keys, sb[l].keys)
                and np.array_equal(sa[l].counts, sb[l].counts)
                and sa[l].tau == sb[l].tau):
            raise AssertionError(f"state round trip: lane l={l} differs")
    qs = _queries([segments.AllKeys(), segments.HashBucket(8, 3, salt=7)])
    if not np.array_equal(a.query_batch(qs).estimates, b.query_batch(qs).estimates):
        raise AssertionError("state round trip: estimates differ")
    log(f"state round trip: state_dict at element {cut} of {n}, restored service "
        "agrees exactly (keys, counts, tau, estimates)")


def run_profile(seed: int, steps: int) -> dict:
    """``torch.profiler`` over ``steps`` chunk steps of a warm service;
    kernel time by name, launches per chunk step and the device's busy
    share of the wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.stats.service import StatsConfig, StreamStatsService

    cfg = StatsConfig()
    rng = np.random.default_rng(seed + 2)
    keys = zipf_keys(rng, 2 * steps * cfg.chunk, 1.2, 1 << 22)
    svc = StreamStatsService(cfg)
    svc.observe(keys[: steps * cfg.chunk])  # warm: tables full, evicting
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.observe(keys[steps * cfg.chunk:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: the ops that launched them repeat their time
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        rows.append({"name": e.key[:160], "count": e.count, "device_us": dev_us})
    rows.sort(key=lambda r: -r["device_us"])
    busy_s = sum(r["device_us"] for r in rows) * 1e-6
    ours = {name: [r for r in rows if tag in r["name"]]
            for name, tag in (("chunksort", "sort_blocks"),
                              ("capscore_agg", "capscore_agg_kernel"))}
    out = {"steps": steps, "wall_ms": wall * 1e3, "step_ms": wall / steps * 1e3,
           "device_busy_ms": busy_s * 1e3, "device_busy_share": busy_s / wall,
           "kernel_launches_per_step": sum(r["count"] for r in rows) / steps,
           "kernel_device_us_per_launch": {
               name: sum(r["device_us"] for r in rs) / max(1, sum(r["count"] for r in rs))
               for name, rs in ours.items()},
           "top": rows[:25]}
    log(f"profile over {steps} chunk steps: {out['step_ms']:.3f} ms/step wall, "
        f"device busy {out['device_busy_ms']:.2f} ms of {out['wall_ms']:.1f} ms "
        f"({100 * out['device_busy_share']:.2f}%), "
        f"{out['kernel_launches_per_step']:.1f} kernel launches per step; "
        f"device us per launch {out['kernel_device_us_per_launch']}")
    for r in rows[:12]:
        log(f"  {r['device_us']:10.1f} us  x{r['count']:6d}  {r['name']}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the distributed two-pass path, 4 ranks on the one card
# ---------------------------------------------------------------------------

RANKS = 4


def _synced(fn, barrier=True):
    """``(fn(), seconds)`` between device syncs (and rank barriers)."""
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    return out, time.perf_counter() - t0


def _counters():
    from repro_torch.kernels.capscore import ops as cops
    from repro_torch.kernels.chunksort import ops as sops

    return {"capscore_multi": cops.capscore_multi_cuda, "capscore": cops.capscore_cuda,
            "capscore_agg": cops.capscore_agg_cuda, "chunksort": sops.sort_with_perm_cuda}


def _counted(fn):
    """``(fn(), seconds, launches)``: every kernel count set to 0 just
    before ``fn`` and read just after."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out, sec = _synced(fn)
    return out, sec, {name: c.launches for name, c in counters.items()}


def _cut_ties(a_keys, a_seeds, b_keys, b_seeds) -> int:
    """Keys in one per-lane summary only; each must tie the other side's
    (k+1)-th seed (the cut), else the summaries disagree."""
    import numpy as np

    a = dict(zip(a_keys[a_keys != EMPTY].tolist(), a_seeds[a_keys != EMPTY].tolist()))
    b = dict(zip(b_keys[b_keys != EMPTY].tolist(), b_seeds[b_keys != EMPTY].tolist()))
    cut_a, cut_b = max(a.values(), default=np.inf), max(b.values(), default=np.inf)
    for x in set(a) ^ set(b):
        seed, cut = (a[x], cut_b) if x in a else (b[x], cut_a)
        if seed != cut:
            raise AssertionError(f"summaries differ on key {x}: seed {seed!r}, the "
                                 f"other side's cut {cut!r}")
    for x in set(a) & set(b):
        if a[x] != b[x]:
            raise AssertionError(f"summaries differ on key {x}'s seed: {a[x]!r} vs {b[x]!r}")
    return len(set(a) ^ set(b))


def _distributed_rank(rank: int, P: int, seed: int, n: int, batch: int,
                      work_dir: str) -> None:
    """One rank of phase 6 (started by ``torch.multiprocessing.spawn``)."""
    sys.path.insert(0, str(SRC))
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as DZ
    from repro_torch.stats.service import StatsConfig, StreamStatsService

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work_dir}/rendezvous",
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=600))
    cfg = StatsConfig()
    keys = zipf_keys(np.random.default_rng(seed), n, 1.2, 1 << 22)  # phase 3's stream
    m = n // P
    shard = keys[rank * m:(rank + 1) * m]
    out = {"rank": rank, "backend": str(dist.get_backend()), "steps": m // cfg.chunk}

    # the user's entry points, counts set to 0 just before each
    torch.cuda.reset_peak_memory_stats()
    prog = {}
    for merge in ("tree", "allgather"):
        fn = DZ.make_distributed_two_pass_multi(ls=cfg.ls, salt=cfg.salt, k=cfg.k,
                                                chunk=cfg.chunk, merge=merge)
        res, out[f"program_{merge}_s"], out[f"launches_{merge}"] = _counted(
            lambda: fn(shard))
        prog[merge] = [t.cpu().numpy() for t in res]
    single = DZ.make_distributed_two_pass(kind="continuous", l=cfg.ls[1], salt=cfg.salt,
                                          k=cfg.k, chunk=cfg.chunk, merge="tree")
    res, out["program_single_s"], out["launches_single"] = _counted(lambda: single(shard))
    prog["single"] = [t.cpu().numpy() for t in res]
    out["max_memory_allocated_program"] = torch.cuda.max_memory_allocated()
    out["digest"] = hashlib.sha256(b"".join(a.tobytes() for v in prog.values()
                                            for a in v)).hexdigest()

    # the same program's stages, timed one by one
    kd = torch.from_numpy(shard.astype(np.int32)).cuda()
    wd = torch.ones(m, dtype=torch.float32, device=kd.device)
    ls = torch.tensor(cfg.ls, dtype=torch.float32, device=kd.device)
    carry, out["pass1_s"] = _synced(lambda: DZ.pass1_local_multi(
        kd, wd, ls=ls, salt=cfg.salt, k=cfg.k, chunk=cfg.chunk))
    merged, out["merge_tree_s"] = _synced(
        lambda: DZ.tree_merge_bottomk_multi(*carry, cfg.k + 1))
    _, out["merge_allgather_s"] = _synced(
        lambda: DZ.allgather_merge_bottomk_multi(*carry, cfg.k + 1))
    sk = torch.sort(merged[0], dim=-1).values
    _, out["pass2_s"] = _synced(lambda: DZ.pass2_shard_multi(kd, wd, sk))
    out["pass2_local_s"] = _synced(lambda: DZ.pass2_local(kd, wd, sk))[1]
    del kd, wd, carry, merged, sk

    # the service path on the same shard, this rank's host id
    torch.cuda.reset_peak_memory_stats()
    svc = StreamStatsService(StatsConfig(host_id=rank))
    _, out["service_observe_s"] = _synced(
        lambda: [svc.observe(shard[lo:lo + batch]) for lo in range(0, m, batch)])
    out["max_memory_allocated_service"] = torch.cuda.max_memory_allocated()
    state = {name: t.cpu().numpy() for name, t in svc.state_dict().items()}
    gathered = [None] * P if rank == 0 else None
    dist.gather_object((out, state), gathered, dst=0)
    if rank == 0:
        result = _merge_and_check(gathered, prog, keys, cfg, batch)
        (Path(work_dir) / "result.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def _merge_and_check(gathered, prog, keys, cfg, batch) -> dict:
    """Rank 0 of phase 6: the service merge and reconcile, and every check."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import freqfns, segments
    from repro_torch.stats.service import StreamStatsService

    ranks = [o for o, _ in gathered]
    P, m = len(ranks), len(keys) // len(ranks)
    for o in ranks:
        if o["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {o['rank']}'s program result differs from rank 0's")
        for merge in ("tree", "allgather"):
            la = o[f"launches_{merge}"]
            if la["capscore_multi"] != o["steps"]:
                raise AssertionError(f"rank {o['rank']} merge={merge}: capscore_multi "
                                     f"launched {la['capscore_multi']} times for "
                                     f"{o['steps']} chunk steps")
        if o["launches_single"]["capscore"] != o["steps"]:
            raise AssertionError(f"rank {o['rank']}: capscore launched "
                                 f"{o['launches_single']['capscore']} times for "
                                 f"{o['steps']} chunk steps")
    for a, b in zip(prog["tree"], prog["allgather"]):
        if not np.array_equal(a, b):
            raise AssertionError("tree and all-gather merges differ")
    for a, b in zip(prog["single"], prog["tree"]):
        if not np.array_equal(a, b[1]):  # the single-l program runs at ls[1]
            raise AssertionError("the single-l program differs from its lane of the grid")
    log(f"phase 6: tree and all-gather merges bit-identical; single-l program equals "
        f"lane l={cfg.ls[1]:g}; replicated on {P} ranks; launches per rank "
        f"{[o['launches_tree'] for o in ranks]}")

    svcs = []
    for r, (_, state) in enumerate(gathered):
        svc = StreamStatsService(dataclasses.replace(cfg, host_id=r))
        svc.load_state_dict(state)
        svcs.append(svc)
    _, t_merge = _synced(lambda: svcs[0].merge_many(svcs[1:], mode="exact"),
                         barrier=False)
    svc = svcs[0]

    def reconcile():
        for r in range(P):
            for lo in range(r * m, (r + 1) * m, batch):
                svc.reconcile(keys[lo:lo + batch])

    _, t_recon = _synced(reconcile, barrier=False)
    bk_keys, bk_seeds = svc._sampler.bottomk_summaries()  # the merged summaries
    pk, ps, pw = prog["tree"]
    ties = 0
    for j in range(len(cfg.ls)):
        ties += _cut_ties(pk[j], ps[j], bk_keys[j], bk_seeds[j])
    log(f"phase 6: merged service summaries equal the program's on every lane "
        f"({ties} keys differ by a seed tie at the (k+1) cut)")

    ukeys, counts = np.unique(keys, return_counts=True)
    exact = svc.exact_sketches()
    for j, l in enumerate(cfg.ls):
        live = pk[j] != EMPTY
        want = counts[np.searchsorted(ukeys, pk[j][live])]
        if not np.array_equal(pw[j][live], want.astype(np.float32)):
            raise AssertionError(f"program pass-II weights differ from the exact counts, l={l}")
        res = exact[float(l)]
        if not np.array_equal(res.counts, counts[np.searchsorted(ukeys, res.keys)]):
            raise AssertionError(f"reconciled weights differ from the exact counts, l={l}")
    log("phase 6: pass-II weights of the program and of reconcile equal the exact counts")

    queries = _queries([segments.AllKeys(), segments.HashBucket(8, 3, salt=7)])
    res = svc.query_batch(queries, exact=True)
    worst = 0.0
    for i, q in enumerate(queries):
        truth = freqfns.exact_statistic(q.fn, counts, q.segment, keys=ukeys)
        est, se = float(res.estimates[i]), float(res.stderr[i])
        if not (np.isfinite(est) and np.isfinite(se)):
            raise AssertionError(f"exact {q.fn.name} {q.segment.describe()}: non-finite")
        z = abs(est - truth) / se if se > 0 else (0.0 if est == truth else np.inf)
        worst = max(worst, z)
        log(f"  exact {q.fn.name:>9} {q.segment.describe():>10} l={res.lanes[i]:g}: "
            f"est {est:.6g} exact {truth:.6g} stderr {se:.4g} |z| {z:.2f}")
        if z > 5.0:
            raise AssertionError(f"exact {q.fn.name} on {q.segment.describe()}: estimate "
                                 f"{est} is {z:.2f} stderr from exact {truth}")
    slowest = lambda name: max(o[name] for o in ranks)  # noqa: E731
    steps = ranks[0]["steps"]
    return {
        "ranks": P, "elements": len(keys), "backend": ranks[0]["backend"],
        "elements_per_s": len(keys) / slowest("program_tree_s"),
        "program_tree_s": slowest("program_tree_s"),
        "program_allgather_s": slowest("program_allgather_s"),
        "program_single_s": slowest("program_single_s"),
        "pass1_ms_per_chunk_step": slowest("pass1_s") / steps * 1e3,
        "merge_tree_ms": slowest("merge_tree_s") * 1e3,
        "merge_allgather_ms": slowest("merge_allgather_s") * 1e3,
        "pass2_ms": slowest("pass2_s") * 1e3,
        "pass2_local_ms": slowest("pass2_local_s") * 1e3,
        "service_observe_s": slowest("service_observe_s"),
        "service_merge_ms": t_merge * 1e3, "service_reconcile_ms": t_recon * 1e3,
        "summary_cut_ties": ties, "worst_abs_z": worst,
        "launches": {"capscore_multi": sum(o["launches_tree"]["capscore_multi"]
                                           for o in ranks),
                     "capscore": sum(o["launches_single"]["capscore"] for o in ranks)},
        "launches_per_rank": [{"tree": o["launches_tree"], "allgather": o["launches_allgather"],
                               "single": o["launches_single"]} for o in ranks],
        "max_memory_allocated_program": [o["max_memory_allocated_program"] for o in ranks],
        "max_memory_allocated_service": [o["max_memory_allocated_service"] for o in ranks],
        "max_memory_allocated_rank0_after_merge": torch.cuda.max_memory_allocated(),
    }


def run_distributed(seed: int, n: int, batch: int) -> dict:
    import torch.multiprocessing as mp

    work_dir = OUT_DIR / "phase6"
    shutil.rmtree(work_dir, ignore_errors=True)
    work_dir.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        mp.spawn(_distributed_rank, args=(RANKS, seed, n, batch, str(work_dir)),
                 nprocs=RANKS, join=True)
        out = json.loads((work_dir / "result.json").read_text())
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 6 ({out['ranks']} ranks on one card, {out['backend']} transport): "
        f"program {out['elements_per_s']:.4g} elements/s ({out['program_tree_s']:.3f} s "
        f"tree, {out['program_allgather_s']:.3f} s all-gather, single-l "
        f"{out['program_single_s']:.3f} s); pass I {out['pass1_ms_per_chunk_step']:.4f} ms "
        f"per chunk step, merge {out['merge_tree_ms']:.3f} ms tree / "
        f"{out['merge_allgather_ms']:.3f} ms all-gather, pass II {out['pass2_ms']:.3f} ms "
        f"(local part {out['pass2_local_ms']:.3f} ms); "
        f"service observe {out['service_observe_s']:.2f} s, merge "
        f"{out['service_merge_ms']:.2f} ms, reconcile {out['service_reconcile_ms']:.2f} ms; "
        f"max_memory_allocated per rank program {out['max_memory_allocated_program']} B, "
        f"service {out['max_memory_allocated_service']} B; worst exact |z| "
        f"{out['worst_abs_z']:.2f}; launches {out['launches']}; whole phase "
        f"{out['phase_s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card {smi}")

    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{k} {v:.2f} s" for k, v in per_source.items()))

    device = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    kernels = [check_chunksort(device, rng), check_capscore_agg(device, rng),
               check_capscore_multi(device, rng), check_capscore(device, rng)]

    main_path = run_main_path(args.seed, 1 << 24, 1 << 20)
    run_state_round_trip(args.seed, 1 << 22)

    profile = run_profile(args.seed, PROFILE_STEPS)
    distributed = run_distributed(args.seed, 1 << 24, 1 << 20)
    launches = {**main_path["launches"], **distributed["launches"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "seed": args.seed, "kernels": kernels, "main_path": main_path,
         "distributed": distributed, "seconds": time.perf_counter() - t_start},
        indent=1))
    (OUT_DIR / "profile_chunk_step.json").write_text(json.dumps(profile, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
