#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the port from ``src/repro_torch/
             kernels/csrc`` with nvcc (one process per source, in parallel).
2. kernels — hold each kernel against its plain PyTorch version on the card
             (chunksort: exact on ragged sizes, ties, EMPTY keys;
             capscore_agg: entered/kb_min/min_score exact, sums rtol 1e-5 on
             key-sorted Zipf chunks, C=2048, L=4 and L=8) and time kernel,
             plain version and, for chunksort, ``torch.sort(stable=True)``.
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
import json
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
    kernels = [check_chunksort(device, rng), check_capscore_agg(device, rng)]

    main_path = run_main_path(args.seed, 1 << 24, 1 << 20)
    for k in kernels:
        k["launches"] = main_path["launches"][k["name"]]
    run_state_round_trip(args.seed, 1 << 22)

    profile = run_profile(args.seed, PROFILE_STEPS)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "seed": args.seed, "kernels": kernels, "main_path": main_path,
         "seconds": time.perf_counter() - t_start}, indent=1))
    (OUT_DIR / "profile_chunk_step.json").write_text(json.dumps(profile, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
