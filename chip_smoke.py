#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run if it fails:

1. build   — compile every CUDA kernel of the port from ``src/repro_torch/
             kernels/csrc`` with nvcc (one process per source, in parallel).
2. kernels — hold each kernel against its plain PyTorch version on the card
             (chunksort: exact on ragged sizes, ties, EMPTY keys;
             capscore_agg: entered/kb_min/min_score exact, sums rtol 1e-5,
             two launches bit-identical, on key-sorted Zipf chunks, C=2048,
             L=4 and L=8, and C in 1..5000 with a key straddling the 2048
             tile, one key filling the chunk, an EMPTY tail and all EMPTY, L
             = 1, 4, 8; capscore_multi and capscore: every output
             bit-identical on ragged N up to 2^20+3, L = 1, 4, 8, views off a
             16-byte boundary, EMPTY keys, non-unit weights and taus mixing
             inf, tau*l > 1 and tau*l < 1) and time kernel, plain version
             and, for chunksort, ``torch.sort(stable=True)`` (per call, and
             the device time of the kernel and of all the kernels one
             torch.sort launches); capscore_agg at the main path's chunk and
             on one key, capscore_multi and capscore at pass I's 2^20 and at
             2048.  The batched entries of the bank's tick: chunksort [B, n]
             at B = 1, 7, 256, 1024 (n 37 and 2048) and capscore_agg [B, C]
             at B = 1, 7, 256 (per-row salts and taus, a one-key chunk, an
             EMPTY tail), each one launch, equal to B single launches bit for
             bit (NaN-aware) and to the plain version as above; device µs per
             chunk at B = 256 beside B = 1, and the batch's bytes bound.
3. main    — ``StreamStatsService(StatsConfig())`` with the service defaults
             (k=4096, ls=(1,16,256,4096), chunk=2048) observes 2^24 Zipf(1.2)
             keys over 2^22 ids in batches of 2^20, then answers one
             query_batch of cap_T, distinct and total over all keys and one
             HashBucket; every estimate must lie within 5 stderr of the exact
             statistic, and the launch counts, reset just before, must show
             that every chunk step went through both kernels; every chunk's
             sort, kept during the run, must equal torch.sort(stable=True).
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
             counts, every exact estimate lies within 5 stderr,
             ``capscore_multi`` (the grid program) and ``capscore`` (the
             single-l one) each launched once per 2^20 elements of a rank's
             shard (pass I scores in batches).
2c. flash_attention — the attention kernels against ``attention_ref`` on
             the card (f32 math; bf16 runs the bf16 tensor-core kernel, f32
             the 3xTF32 tensor-core kernel): (B,Hq,Hkv,S,D) = (2,4,4,256,64), (2,4,2,256,64),
             (2,8,1,384,128), (1,2,2,128,16) and a ragged (1,4,2,200,32), each
             causal and not, contiguous and strided, f32 (tolerance 2e-5)
             and bf16 (2e-2); and the
             serving prefill's shape (4,32,4,4096,128) causal, on the
             strided [B,S,H,D] views the prefill hands it, in f32 (2e-5) and
             bf16 (atol 1e-4, rtol 2^-7: one bf16 ulp); each tensor-core
             kernel timed beside the plain version and
             ``scaled_dot_product_attention`` in its dtype, the f32 one also
             beside the FMA kernel it replaced, in the same call.
7. LM serving — yi-6b at full width (32 layers, d_model 4096, bf16, random
             weights from a seeded generator on the card), attention through
             the bf16 tensor-core kernel: a batched prefill of 4 prompts of
             4096 tokens (32 launches of it and none of the f32 kernels, by
             the counters and by the profile), profiled once; 32 greedy
             ``decode_step``s; the
             prefill held against the plain chunked attention path and the
             last decode step against a plain prefill of all 4128 tokens;
             then ``DecodeServer`` answers the reference demo's 6 requests;
             last, the weights upcast to f32, the prefill, profiled, through
             the 3xTF32 kernel (32 launches of it and none of the others, by
             the counters and by the profile) against the plain path again,
             where f32 sum orders are the only difference and a subtle
             attention fault shows.
2d. segment_sum — the segmented-sum kernel against ``segment_sum_ref`` on the
             card at rtol 1e-5 / atol 1e-5 max|want| (integer-valued rows
             exactly), each case launched twice (bit-identical): the
             reference test space (N 1..2000, D 8/64/256, S 4/128/1024,
             ids sorted and not), the tile([7,3,7,0]) case, empty segments,
             out-of-range ids, all rows dropped, bf16/f16 rows, a Zipf
             scatter (2^24 rows of 64 into 2^20 segments) driven through
             ``ops.segment_sum`` (the generic op's path, its launches
             counted), and the two-tower pooling shapes (25,600 and
             13,107,200 rows of 256 into 512 and 262,144 bags), timed beside
             the plain version and ``index_add_``.
    embedding_bag — the gather-fused kernel against ``embedding_bag_ref``
             at the same gate, each case launched twice (bit-identical): D
             3/8/64/256, f32/bf16/f16 tables, sum, mean and weighted, empty
             and padding-only bags, ids past the table, bags sorted (with and
             without the caller's promise) and not, integer-valued rows
             exactly; and both two-tower pooling shapes over a 1M-row table
             (Zipf ids, 10% padding), timed beside the plain version,
             ``F.embedding_bag(mode="mean", padding_idx=0)`` and the gather ->
             ``segment_sum`` composition it replaced, with its device time
             per launch against the bytes bound.
8. recsys serving — two-tower-retrieval at full size (10M items and 50M
             users x 256, f32: 61.44 GB of tables, random weights from a
             seeded generator on the card) at serve_p99 (B=512), serve_bulk
             (B=262,144) and retrieval_cand (one user, 2^20 candidates,
             top-100), the history pooling through the gather-fused
             ``embedding_bag`` kernel (one launch per call, no segment_sum;
             serve_p99's pooling once under ``torch.cuda.
             set_sync_debug_mode("error")``, so a host sync fails the run),
             each held against the reference's masked_mean formula; a
             ``StreamStatsService`` sketches the serve_bulk item
             stream, ``plan_hot_cold(4096)`` splits the table and
             ``hot_cold_lookup`` must equal ``embed_lookup``; then din, bst
             and mind at full size at serve_p99.

9. multi-tenant serving — ``MultiTenantStats`` + ``StatsScheduler`` through
             ``step``: run A at ``stats_serve.main``'s defaults (64 tenants,
             ``StatsConfig(k=512, ls=(1, 8, 64), chunk=2048)``, 40 steps of 16
             ingest slices of 2048 Zipf(1.3) keys mod 100,000, 400 Poisson
             queries of cap T in {1..64} on all keys or ``HashBucket(8, b)``,
             256 per batch, seed 0), every tenant held bit for bit against a
             standalone ``StreamStatsService`` fed the same slices (every
             query answer of its step, every state leaf at the end); run B at
             a deployment's scale (1024 tenants at ``StatsConfig()``, a 0.54
             GB bank, 64 steps of 256 slices, 2048 queries), five tenants
             held so, a checkpoint at step 32 restored into a fresh bank and
             continued (every leaf equal), one tenant ``restore_slice``d
             into a standalone service and continued (equal).  Both: one
             chunksort and one capscore_agg launch per stacked step (a tick,
             or a refresh's padded flush), every ``tick`` and query dispatch
             under ``torch.cuda.set_sync_debug_mode("error")``; elements/s,
             queries/s, p50/p99 latency, tick ms by CUDA events, device busy
             share over 8 profiled steps after the measured ones,
             ``resident_bytes``, ``max_memory_allocated``, with the card's
             name and power limit.
10. samplers — the paper's samplers over phase 3's stream (2^24 Zipf(1.2)
             keys on 2^22 ids, from ``--seed``); a cut of a size is logged
             on its line.  10a: ``IncrementalSampler(l=16, k=4096)`` in
             batches of 2^20 bit-identical to ``sample_fixed_k``, the cap_16
             estimate within 5 stderr of exact, one ``capscore_agg`` and one
             ``chunksort`` launch per chunk step, elements/s, ms per step,
             8 profiled steps, and an ``evict_every=4`` sampler finalizing
             <= k keys.  10b: ``sample_fixed_tau`` and
             ``IncrementalSampler(tau=...)`` bit-identical for continuous and
             discrete (l=16), distinct (1) and sh (1e9) at the tau whose
             expected sample is 4096 keys (capacity 16384); the first 2^18
             elements against Algorithms 4 / 2 on the host (keys equal;
             counts within rtol 1e-4 / atol 1e-3, hash-only exact); a small
             capacity raises at finalize.  10c: ``sample_two_pass(k=4096)``
             for the four kinds: pass-II weights equal to the exact counts,
             the first 2^18 elements equal to Algorithm 1 (keys, tau and
             counts within rtol 1e-5), ``capscore`` once per 2^20 elements.
             10d: ``StatsConfig()``'s grid over the first 2^22 elements,
             ``update_multi(reference=True)`` beside the fused route chunk
             by chunk: keys, kb, seeds, steps and summaries exact, counts
             and tau within rtol 1e-5, a lane whose keys split dropped only
             when every differing key has a deciding eviction race within 4
             ulp; one ``capscore_multi`` launch per chunk step.  10e:
             ``multiobjective_sample(k=4096, ls=(1, 16, 256, 4096))``: the
             card's ``per_key_randomness`` against numpy (keys and hx
             exact, y and wx within 2 f64 ulp), |S_L| against k ln n, the
             relative error of ``estimate_multi`` for cap_T.

The results and the profile are also written as JSON to ``chiprun_out/``
in the checkout (git-ignored).

It imports nothing of JAX or of the reference package ``repro``.  It exits
non-zero without a CUDA device, and when run without the rest of the repo.
The card's name and power limit (``nvidia-smi``) come two lines before the
last, the ``kernels`` JSON on the line before the last (each kernel's
launches on its path, and ``launches_phase10`` on 10a-10d's), and the last line is
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
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
TF32_TENSOR_OPS_PER_S = 495e12  # dense TF32 tensor-core rate
SALT = 0x5EED
EMPTY = 2**31 - 1


def exact_f32() -> None:
    """f32 products in full f32 (no TF32), as the plain versions assume."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def _device_profile(fn, calls: int, tag: str, others: tuple = ()) -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn``: device time and
    kernel launches per call, the device's busy share of the wall time, the
    device time of the kernels whose name holds ``tag`` (per call, as a
    share of the device time, and per launch) and their launches per call,
    the launches per call of the kernels whose name holds each of
    ``others``, and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches, tag_us, tag_n, rows = 0.0, 0, 0.0, 0, []
    other_n = dict.fromkeys(others, 0)
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        busy_us += dev_us
        launches += e.count
        rows.append({"name": e.key[:120], "launches_per_call": e.count / calls,
                     "device_ms_per_call": dev_us * 1e-3 / calls})
        if tag in e.key:
            tag_us += dev_us
            tag_n += e.count
        for o in others:
            other_n[o] += e.count if o in e.key else 0
    rows.sort(key=lambda r: -r["device_ms_per_call"])
    return {"calls": calls, "wall_ms_per_call": wall * 1e3 / calls,
            "device_busy_ms_per_call": busy_us * 1e-3 / calls,
            "device_busy_share": busy_us * 1e-6 / wall,
            "kernel_launches_per_call": launches / calls, "kernel": tag,
            "kernel_device_ms_per_call": tag_us * 1e-3 / calls,
            "kernel_share_of_device": tag_us / busy_us if busy_us else None,
            "kernel_device_us_per_launch": tag_us / tag_n if tag_n else None,
            "tag_launches_per_call": tag_n / calls,
            "other_launches_per_call": {o: n / calls for o, n in other_n.items()},
            "top": rows[:8]}


def _kernel_device_us(fn, calls: int, tag: str, tries: int = 3) -> float:
    """Device µs per launch of the kernels whose name holds ``tag`` over
    ``calls`` calls of ``fn`` (``_device_profile``), profiled again when the
    trace holds none of them: ``torch.profiler`` now and then records no
    device event of a window on an H100 host.  Raises when every try
    misses."""
    for _ in range(tries):
        us = _device_profile(fn, calls, tag)["kernel_device_us_per_launch"]
        if us is not None:
            return us
    raise AssertionError(f"torch.profiler recorded no {tag} launch in {tries} windows "
                         f"of {calls} calls")


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_chunksort(device, rng) -> dict:
    import numpy as np
    import torch
    from repro_torch.data.streams import zipf_keys
    from repro_torch.kernels.chunksort import ops

    cases = []
    for n in (1, 2, 7, 2047, 2048, 2049, 65536):
        cases.append(("random", rng.integers(0, max(2, n // 3), n)))
    for n in (2048, 4096):
        cases.append(("ties", rng.integers(0, 3, n)))
    mix = rng.integers(-20, 50, 2049)
    mix[rng.random(2049) < 0.3] = EMPTY
    cases.append(("empty_mix", mix))
    cases.append(("all_empty", np.full(2048, EMPTY)))
    cases.append(("all_empty", np.full(4097, EMPTY)))
    cases.append(("int32_extremes", rng.choice([-2**31, -1, 0, 1, EMPTY - 1, EMPTY], 2048)))
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
    # device time: the kernel's own, and all the kernels of one torch.sort call
    dev_us = _kernel_device_us(lambda: ops.sort_with_perm_cuda(keys), 50,
                               "sort_chunk")
    lib_prof = _device_profile(lambda: torch.sort(keys, stable=True), 50, "")
    lib_dev_us = lib_prof["device_busy_ms_per_call"] * 1e3
    # bytes: read keys once, write ks (int32) and perm (int64); operations:
    # the bitonic network's compare-exchanges at the padded power of two
    P = 1 << max(0, n - 1).bit_length()
    lg = P.bit_length() - 1
    b, by = bound_ms(4 * n + 4 * n + 8 * n, (P // 2) * lg * (lg + 1) // 2 * 4)
    log(f"chunksort n={n}: kernel {ms:.4f} ms per call, {dev_us} us device per launch; "
        f"plain {plain:.4f} ms; torch.sort {library:.4f} ms per call, {lib_dev_us} us "
        f"device per call ({lib_prof['kernel_launches_per_call']} kernels); bound "
        f"{b:.6f} ms ({by})")
    return {"name": "chunksort", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunksort.cu",
            "replaces": "src/repro/kernels/chunksort/chunksort.py:135",
            "launches": None, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": library,
            "device_us": dev_us, "library_device_us": lib_dev_us}


# capscore_agg's edge cases: (kind, C); kinds as in _agg_inputs
AGG_EDGE_CASES = ([(kind, C) for kind in ("zipf", "straddle") for C in (1, 37, 2048, 5000)]
                  + [(kind, C) for kind in ("one_key", "empty_tail", "all_empty")
                     for C in (37, 2048, 5000)])


def _agg_inputs(device, rng, C: int, L: int, kind: str = "zipf"):
    """A key-sorted chunk (the ChunkOrder view) and L lanes: Zipf(1.2) keys
    over 2^22 ids (the main path's), or a key of 200 elements straddling the
    2048-element tile boundary (from 1990), one key filling the chunk, an
    EMPTY third at the end, all EMPTY."""
    import numpy as np
    import torch
    from repro_torch.core.segments import chunk_order
    from repro_torch.data.streams import zipf_keys

    keys = zipf_keys(rng, C, 1.2, 1 << 22).astype(np.int32)
    if kind == "straddle" and C > 2190:
        keys[:1990] = np.arange(1990)
        keys[1990:2190] = 1 << 22
        keys[2190:] += (1 << 22) + 1
    elif kind == "one_key":
        keys[:] = 42
    elif kind == "empty_tail":
        keys[-max(1, C // 3):] = EMPTY
    elif kind == "all_empty":
        keys[:] = EMPTY
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = np.ones(C, np.float32)
    ws[: C // 4] = rng.random(C // 4).astype(np.float32) * 3 + 0.05
    order = chunk_order(*(torch.from_numpy(a).to(device) for a in (keys, eids, ws)))
    ls = np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0], np.float32), L)
    # tau = inf, tau*l > 1 and tau*l < 1 lanes
    taus = np.resize(np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2], np.float32), L)
    return (order.ks, order.eids, order.ws, order.seg,
            torch.from_numpy(ls).to(device), torch.from_numpy(taus).to(device), SALT)


def _max_abs_err(got, want) -> float:
    import torch

    err = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        same = (g == w) | (g.isnan() & w.isnan())  # inf == inf, NaN at NaN
        d = torch.where(same, torch.zeros_like(g), (g - w).abs())
        err = max(err, float(d.max()))
    return err


def _same_bits(got, want) -> bool:
    """Equal dtypes and values, NaN where the other has NaN: Delta is inf /
    inf = NaN in a tau = inf lane for the element whose uniform rounds to
    1.0 (h >> 8 = 2^24 - 1, about one in 2^24), in both versions."""
    import torch

    if got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(got[~nan], want[~nan])


def _hold_agg(ops, args, what: str) -> float:
    """The kernel twice and the plain version on one chunk: entered, kb_min,
    min_score exact, the sums within rtol 1e-5, both launches the same
    bits.  Returns the largest absolute difference."""
    import torch

    got = ops.capscore_agg_cuda(*args)
    again = ops.capscore_agg_cuda(*args)
    want = ops.capscore_agg_ref(*args)
    torch.cuda.synchronize()
    for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"capscore_agg {name} differs from the plain version ({what})")
    for i, name in ((0, "w_total"), (2, "contrib")):
        if not torch.allclose(got[i], want[i], rtol=1e-5, atol=0):
            raise AssertionError(f"capscore_agg {name} beyond rtol 1e-5 ({what})")
    for g, a in zip(got, again):
        if not torch.equal(g, a):
            raise AssertionError(f"capscore_agg: two launches differ ({what})")
    return _max_abs_err(got, want)


def check_capscore_agg(device, rng) -> tuple[dict, dict]:
    from repro_torch.kernels.capscore import ops

    err, n_cases = 0.0, 0
    for L in (4, 8):
        for rep in range(3):
            err = max(err, _hold_agg(ops, _agg_inputs(device, rng, 2048, L),
                                     f"zipf C=2048 L={L} rep {rep}"))
            n_cases += 1
    for kind, C in AGG_EDGE_CASES:
        for L in (1, 4, 8):
            err = max(err, _hold_agg(ops, _agg_inputs(device, rng, C, L, kind),
                                     f"{kind} C={C} L={L}"))
            n_cases += 1
    log(f"capscore_agg: entered/kb_min/min_score exact, sums within rtol 1e-5, two "
        f"launches bit-identical on {n_cases} chunks (C 1..5000, L 1/4/8, tile-straddling "
        f"key, one key, EMPTY tail, all EMPTY); max abs err {err:.3e}")

    args = _agg_inputs(device, rng, 2048, 4)  # the main path's shape
    C, L = args[0].shape[0], args[4].shape[0]
    ms = cuda_ms(lambda: ops.capscore_agg_cuda(*args))
    plain = cuda_ms(lambda: ops.capscore_agg_ref(*args))
    dev_us = _kernel_device_us(lambda: ops.capscore_agg_cuda(*args), 50,
                               "capscore_agg_kernel")
    # the old one-warp-per-key design's worst case: one key in all 2048
    one = _agg_inputs(device, rng, 2048, 4, "one_key")
    one_us = _kernel_device_us(lambda: ops.capscore_agg_cuda(*one), 50,
                               "capscore_agg_kernel")
    # bytes: ks/eids/ws/seg once (16 B/element), ls/taus, and the outputs
    # (w_total f32, then entered u8 + three f32 columns per lane);
    # operations: ~40 integer ops for the element hash, ~30 for log1p and
    # the divisions, ~10 per lane
    n_bytes = 16 * C + 8 * L + 4 * C + 13 * L * C
    b, by = bound_ms(n_bytes, C * (70 + 10 * L))
    log(f"capscore_agg C={C} L={L}: kernel {ms:.4f} ms per call, {dev_us} us device per "
        f"launch ({one_us} us on one key), plain {plain:.4f} ms, bound {b:.6f} ms ({by}), "
        f"{100 * b * 1e3 / dev_us:.2f}% of it")
    return {"name": "capscore_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/capscore_agg.cu",
            "replaces": "src/repro/kernels/capscore/capscore.py:466",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "device_us": dev_us, "one_key_device_us": one_us}, dev_us


# the batched entries' batch sizes: B = 256 is a bank tick of run B
SORT_ROWS_BATCHES = (1, 7, 256, 1024)
AGG_BATCHES = (1, 7, 256)


def check_chunksort_rows(device, rng) -> dict:
    """The batched chunk sort ([B, n], one CTA per row) against B single
    launches and the plain version, bit for bit; device µs per chunk at
    B = 256 beside B = 1, and the batch's bytes bound."""
    import numpy as np
    import torch
    from repro_torch.data.streams import zipf_keys
    from repro_torch.kernels.chunksort import ops

    n_cases = 0
    for B in SORT_ROWS_BATCHES:
        for n in (37, 2048):
            keys = zipf_keys(rng, B * n, 1.2, 1 << 22).reshape(B, n).astype(np.int32)
            keys[B // 2, :] = 42                    # one key filling a row
            keys[-1, -max(1, n // 3):] = EMPTY      # an EMPTY tail
            k = torch.from_numpy(keys).to(device)
            before = ops.sort_with_perm_cuda.launches
            got = ops.sort_with_perm_cuda(k)
            if ops.sort_with_perm_cuda.launches != before + 1:
                raise AssertionError(f"chunksort rows B={B}: not one launch")
            want = ops.sort_with_perm_ref(k)
            rows = [ops.sort_with_perm_cuda(k[b]) for b in range(B)]
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"chunksort rows differ from the plain version: B={B} n={n}")
            for b, (ks, perm) in enumerate(rows):
                if not (torch.equal(got[0][b], ks) and torch.equal(got[1][b], perm)):
                    raise AssertionError(f"chunksort rows: row {b} of B={B} n={n} differs "
                                         "from its single launch")
            n_cases += 1
    log(f"chunksort rows: bit-identical to B single launches and torch.sort(stable=True) "
        f"on {n_cases} batches (B {SORT_ROWS_BATCHES}, n 37 and 2048)")
    out = {}
    for B in (1, 256):
        k = torch.from_numpy(zipf_keys(rng, B * 2048, 1.2, 1 << 22).reshape(B, 2048)
                             .astype(np.int32)).to(device)
        us = _kernel_device_us(lambda: ops.sort_with_perm_cuda(k), 20,
                               "sort_chunk")
        b, by = bound_ms(16 * B * 2048, 0)
        out[f"rows_b{B}_device_us_per_chunk"] = us / B
        out[f"rows_b{B}_bound_ms"] = b
    log(f"chunksort rows n=2048: {out['rows_b1_device_us_per_chunk']:.4f} us device per "
        f"chunk at B=1, {out['rows_b256_device_us_per_chunk']:.4f} at B=256; bytes bound of "
        f"the B=256 batch {out['rows_b256_bound_ms']:.6f} ms")
    return out


def _agg_batch_inputs(device, rng, B: int, C: int, L: int, edges: bool = True):
    """B key-sorted chunks of one batch: Zipf rows, with ``edges`` a one-key
    row and an EMPTY-tailed row; per-row salts and taus mixing inf,
    tau*l > 1 and tau*l < 1."""
    import numpy as np
    import torch
    from repro_torch.core.segments import chunk_order
    from repro_torch.data.streams import zipf_keys

    keys = zipf_keys(rng, B * C, 1.2, 1 << 22).reshape(B, C).astype(np.int32)
    if edges:
        keys[B // 2, :] = 42
        keys[-1, -max(1, C // 3):] = EMPTY
    eids = rng.integers(0, 2**31 - 1, (B, C)).astype(np.int32)
    ws = np.ones((B, C), np.float32)
    ws[:, : C // 4] = rng.random((B, C // 4)).astype(np.float32) * 3 + 0.05
    order = chunk_order(*(torch.from_numpy(a).to(device) for a in (keys, eids, ws)))
    ls = np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0], np.float32), L)
    taus = rng.choice(np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, 5e-4, 0.2], np.float32), (B, L))
    salts = rng.integers(0, 2**32, B).astype(np.uint32)
    salts[0] = SALT
    return (order.ks, order.eids, order.ws, order.seg, torch.from_numpy(ls).to(device),
            torch.from_numpy(taus).to(device),
            torch.from_numpy(salts.view(np.int32)).to(device)), salts


def check_capscore_agg_batch(device, rng) -> dict:
    """The batched capscore_agg (grid (B, 1 + helpers)) against B single
    launches (NaN-aware, bit for bit) and the plain version (entered,
    kb_min, min_score exact; sums within rtol 1e-5); device µs per chunk at
    B = 256 beside B = 1, and the batch's bytes bound."""
    import torch
    from repro_torch.kernels.capscore import ops

    err, n_cases = 0.0, 0
    for B in AGG_BATCHES:
        for C, L in ((2048, 4), (37, 1), (2048, 8)):
            args, salts = _agg_batch_inputs(device, rng, B, C, L)
            before = ops.capscore_agg_cuda.launches
            got = ops.capscore_agg_cuda(*args)
            if ops.capscore_agg_cuda.launches != before + 1:
                raise AssertionError(f"capscore_agg batch B={B}: not one launch")
            ks, eids, ws, seg, ls, taus, _ = args
            for b in range(B):
                one = ops.capscore_agg_cuda(ks[b], eids[b], ws[b], seg[b], ls, taus[b],
                                            int(salts[b]))
                for name, g, w in zip(("w_total", "entered", "contrib", "kb_min",
                                       "min_score"), got, one):
                    if not _same_bits(g[b], w):
                        raise AssertionError(f"capscore_agg batch: {name} of row {b} "
                                             f"(B={B} C={C} L={L}) differs from its single launch")
            want = ops.capscore_agg_ref(*args)
            torch.cuda.synchronize()
            for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
                if not torch.equal(got[i], want[i]):
                    raise AssertionError(f"capscore_agg batch {name} differs from the plain "
                                         f"version (B={B} C={C} L={L})")
            for i, name in ((0, "w_total"), (2, "contrib")):
                if not torch.allclose(got[i], want[i], rtol=1e-5, atol=0):
                    raise AssertionError(f"capscore_agg batch {name} beyond rtol 1e-5 "
                                         f"(B={B} C={C} L={L})")
            err = max(err, _max_abs_err(got, want))
            n_cases += 1
    log(f"capscore_agg batch: bit-identical to B single launches (NaN-aware) and to the "
        f"plain version (sums within rtol 1e-5) on {n_cases} batches (B {AGG_BATCHES}, "
        f"mixed salts and taus, a one-key chunk, an EMPTY tail); max abs err {err:.3e}")
    out = {"batch_max_abs_err": err}
    for B in (1, 256):  # the main path's Zipf chunks
        args, _ = _agg_batch_inputs(device, rng, B, 2048, 4, edges=False)
        us = _kernel_device_us(lambda: ops.capscore_agg_cuda(*args), 20,
                               "capscore_agg_kernel")
        C, L = 2048, 4
        b, by = bound_ms(B * (16 * C + 4 * L + 4 + 4 * C + 13 * L * C) + 4 * L,
                         B * C * (70 + 10 * L))
        out[f"batch_b{B}_device_us_per_chunk"] = us / B
        out[f"batch_b{B}_bound_ms"] = b
        out[f"batch_b{B}_bound_by"] = by
    log(f"capscore_agg batch C=2048 L=4: {out['batch_b1_device_us_per_chunk']:.4f} us "
        f"device per chunk at B=1, {out['batch_b256_device_us_per_chunk']:.4f} at B=256; "
        f"bound of the B=256 batch {out['batch_b256_bound_ms']:.6f} ms "
        f"({out['batch_b256_bound_by']})")
    return out


def _score_inputs(device, rng, N: int, L: int, offset: int = 0):
    """Unsorted elements (5% EMPTY keys, a quarter non-unit weights) and
    lanes mixing tau = inf, tau*l > 1 and tau*l < 1; ``offset`` > 0 gives
    views that many elements into their allocations."""
    import numpy as np
    import torch
    from repro_torch.data.streams import zipf_keys

    M = N + offset
    keys = zipf_keys(rng, M, 1.2, 1 << 22).astype(np.int32)
    keys[rng.random(M) < 0.05] = EMPTY
    eids = rng.integers(-2**31, 2**31 - 1, M).astype(np.int32)
    ws = np.ones(M, np.float32)
    ws[: M // 4] = rng.random(M // 4).astype(np.float32) * 3 + 0.05
    ls = np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.3, 64.0, 1024.0, 0.7],
                            np.float32), L)
    taus = np.resize(np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2],
                              np.float32), L)
    return ([torch.from_numpy(a).to(device)[offset:] for a in (keys, eids, ws)],
            torch.from_numpy(ls).to(device), torch.from_numpy(taus).to(device))


def check_capscore_multi(device, rng) -> dict:
    import torch
    from repro_torch.core.distributed import SCORE_BATCH  # pass I's launch
    from repro_torch.kernels.capscore import ops

    cases = [(N, L, 0) for N in (1, 7, 2047, 2048, 2049, 65536) for L in (1, 4, 8)]
    cases += [(SCORE_BATCH, 4, 0)]  # phase 6's pass-I launch: every store 16 bytes
    cases += [(SCORE_BATCH + 3, L, 0) for L in (1, 4)]
    cases += [(N, 4, 1) for N in (2048, SCORE_BATCH + 3)]  # off 16 bytes
    err = 0.0
    for N, L, offset in cases:
        elems, ls, taus = _score_inputs(device, rng, N, L, offset)
        got = ops.capscore_multi_cuda(*elems, ls, taus, SALT)
        want = ops.capscore_multi_ref(*elems, ls, taus, SALT)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("score", "delta", "entry", "kb")):
            if not _same_bits(g, w):
                raise AssertionError(f"capscore_multi {name} differs from the plain "
                                     f"version (N={N}, L={L}, offset {offset})")
        err = max(err, _max_abs_err(got, want))
    log(f"capscore_multi: every output bit-identical to the plain version on "
        f"{len(cases)} cases (N in 1..2^20+3 with pass I's 2^20, L in 1, 4, 8, views "
        f"off 16 bytes)")
    # phase 6's pass-I launch (2^20 elements) and one 2048-element chunk
    rows = {}
    for N in (SCORE_BATCH, 2048):
        L = 4
        elems, ls, taus = _score_inputs(device, rng, N, L)
        call = lambda: ops.capscore_multi_cuda(*elems, ls, taus, SALT)  # noqa: E731
        ms = cuda_ms(call, *((50, 5) if N > 65536 else (200, 20)))
        plain = cuda_ms(lambda: ops.capscore_multi_ref(*elems, ls, taus, SALT),
                        *((20, 3) if N > 65536 else (200, 20)))
        dev_us = _kernel_device_us(call, 20, "capscore_multi_kernel")
        # bytes: keys/eids/weights once (12 B/element), ls/taus, and four [L, N]
        # outputs of 4 B; operations: ~40 integer ops per element hash (two),
        # ~30 for log1p and the divisions, ~10 per lane
        b, by = bound_ms(12 * N + 8 * L + 16 * L * N, N * (110 + 10 * L))
        rows[N] = {"N": N, "L": L, "ms": ms, "plain_ms": plain, "device_us": dev_us,
                   "bound_ms": b, "bound_by": by, "bound_share": b * 1e3 / dev_us}
        log(f"capscore_multi N={N} L={L}: kernel {ms:.4f} ms per call ({dev_us} us device "
            f"per launch), plain {plain:.4f} ms, bound {b:.6f} ms ({by}), "
            f"{100 * b * 1e3 / dev_us:.2f}% of it")
    main = rows[SCORE_BATCH]
    return {"name": "capscore_multi", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/capscore.cu",
            "replaces": "src/repro/kernels/capscore/capscore.py:270",
            "launches": None, "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "device_us": main["device_us"],
            "at_one_chunk": rows[2048]}, main["device_us"]


def check_capscore(device, rng) -> dict:
    import torch
    from repro_torch.core.distributed import SCORE_BATCH  # the single-l pass I's launch
    from repro_torch.kernels.capscore import ops

    lanes = ((1.0, float("inf")), (16.0, 0.5), (256.0, 1e-3), (3.3, 0.9), (0.7, 0.2))
    cases = [(N, 0) for N in (1, 7, 2047, 2048, 2049, 65536, SCORE_BATCH, SCORE_BATCH + 3)]
    cases += [(N, 1) for N in (2048, SCORE_BATCH + 3)]  # off 16 bytes
    n_cases, err = 0, 0.0
    for N, offset in cases:
        elems, _, _ = _score_inputs(device, rng, N, 1, offset)
        for l, tau in lanes:
            got = ops.capscore_cuda(*elems, l, tau, SALT)
            want = ops.capscore_ref(*elems, l, tau, SALT)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("score", "delta", "entry")):
                if not _same_bits(g, w):
                    raise AssertionError(f"capscore {name} differs from the plain version "
                                         f"(N={N}, offset {offset}, l={l}, tau={tau})")
            err = max(err, _max_abs_err(got, want))
            n_cases += 1
    log(f"capscore: every output bit-identical to the plain version on {n_cases} "
        f"cases (N in 1..2^20+3 with the single-l pass I's 2^20, views off 16 bytes)")
    # the single-l pass I's launch (2^20 elements) and one 2048-element chunk
    rows = {}
    for N in (SCORE_BATCH, 2048):
        elems, _, _ = _score_inputs(device, rng, N, 1)
        call = lambda: ops.capscore_cuda(*elems, 16.0, float("inf"), SALT)  # noqa: E731
        ms = cuda_ms(call, *((50, 5) if N > 65536 else (200, 20)))
        plain = cuda_ms(lambda: ops.capscore_ref(*elems, 16.0, float("inf"), SALT),
                        *((20, 3) if N > 65536 else (200, 20)))
        dev_us = _kernel_device_us(call, 20, "capscore_kernel")
        # bytes: keys/eids/weights read once and score/delta/entry written
        # once, 12 B each per element; operations: ~120 per element
        b, by = bound_ms(24 * N, N * 120)
        rows[N] = {"N": N, "ms": ms, "plain_ms": plain, "device_us": dev_us,
                   "bound_ms": b, "bound_by": by, "bound_share": b * 1e3 / dev_us}
        log(f"capscore N={N}: kernel {ms:.4f} ms per call ({dev_us} us device per launch), "
            f"plain {plain:.4f} ms, bound {b:.6f} ms ({by}), {100 * b * 1e3 / dev_us:.2f}% "
            f"of it")
    main = rows[SCORE_BATCH]
    return {"name": "capscore", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/capscore.cu",
            "replaces": "src/repro/kernels/capscore/capscore.py:166",
            "launches": None, "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "device_us": main["device_us"],
            "at_one_chunk": rows[2048]}, main["device_us"]


FLASH_CASES = ((2, 4, 4, 256, 64), (2, 4, 2, 256, 64), (2, 8, 1, 384, 128),
               (1, 2, 2, 128, 16), (1, 4, 2, 200, 32))
PREFILL_SHAPE = (4, 32, 4, 4096, 128)  # yi-6b's serving prefill: B, Hq, Hkv, S, D
# the reference's own tolerances for its flash kernel against the naive
# oracle (tests/test_kernels.py): the online softmax sums in another order,
# and a bf16 output may round to the other side (one ulp is 2^-8 relative)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (atol, rtol) at the prefill shape, where most outputs are ~0.03 and 2e-2
# would hide a dropped kv tile on the long rows.  Both sides round one f32
# result to bf16, so they differ by at most one ulp, <= 2^-7 of |want|; atol
# covers values near 0.  f32 keeps the reference's 2e-5 (0.07% of 0.03).
# The limits sit between the readings of the kernel and of the planted
# faults of flash_fault_check.py (PERF.md, PR 13).
PREFILL_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 2**-7)}


class CheckFailed(AssertionError):
    """Failed checks, with the readings they were made from."""

    def __init__(self, failures, readings):
        super().__init__("; ".join(failures))
        self.readings = readings


def _flash_inputs(gen, shape, dtype, strided: bool):
    """q, k, v ~ N(0, 1) as [B, H, S, D]; ``strided`` gives them as the
    transposed views of [B, S, H, D] tensors that the prefill passes."""
    import torch

    B, Hq, Hkv, S, D = shape
    out = []
    for H in (Hq, Hkv, Hkv):
        x = torch.randn((B, S, H, D), generator=gen, device=gen.device).to(dtype)
        out.append(x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous())
    return out


def _closeness(got, want, atol: float, rtol: float) -> dict:
    """Max abs error, relative L2 and the worst |got - want| / (atol +
    rtol |want|), which must stay <= 1."""
    import torch

    got, want = got.float(), want.float()
    d = (got - want).abs()
    return {"max_abs": float(d.max()), "rel_l2": float((got - want).norm() / want.norm()),
            "worst_ratio": float((d / (atol + rtol * want.abs())).max()),
            "finite": bool(torch.isfinite(got).all())}


def check_flash_prefill(gen) -> tuple:
    """The kernels at the prefill shape, causal, in f32 (the 3xTF32 kernel)
    and bf16 (the tensor-core kernel), on the strided views the prefill passes,
    against ``attention_ref`` at ``PREFILL_TOL``.  Returns (readings, {dtype:
    (q, k, v)}); raises ``CheckFailed`` with the readings if either dtype
    fails."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    readings, failures, inputs = {}, [], {}
    for dtype in ("float32", "bfloat16"):
        q, k, v = inputs[dtype] = _flash_inputs(gen, PREFILL_SHAPE, getattr(torch, dtype), True)
        got = ops.flash_attention_cuda(q, k, v, causal=True)
        want = ops.attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        atol, rtol = PREFILL_TOL[dtype]
        r = readings[dtype] = _closeness(got, want, atol, rtol)
        r["worst_ratio_at_reference_tol"] = _closeness(
            got, want, FLASH_TOL[dtype], FLASH_TOL[dtype])["worst_ratio"]
        if not (r["finite"] and r["worst_ratio"] <= 1.0):
            failures.append(f"flash_attention at the prefill shape, {dtype}: max abs "
                            f"{r['max_abs']}, worst |d| / (atol + rtol |want|) "
                            f"{r['worst_ratio']} (atol {atol}, rtol {rtol})")
        del got, want
        torch.cuda.empty_cache()
    if failures:
        raise CheckFailed(failures, readings)
    return readings, inputs


def check_flash_attention(device, seed: int) -> tuple[list, dict]:
    """Phase 2c: the two kernels' entries for the ``kernels`` line (bf16,
    then f32), and the readings at the prefill shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    n_cases, err = 0, {"float32": 0.0, "bfloat16": 0.0}
    for shape in FLASH_CASES:
        for dtype in ("float32", "bfloat16"):
            for causal in (True, False):
                for strided in (False, True):
                    q, k, v = _flash_inputs(gen, shape, getattr(torch, dtype), strided)
                    got = ops.flash_attention_cuda(q, k, v, causal=causal)
                    want = ops.attention_ref(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    d = float((got.float() - want.float()).abs().max())
                    tol = FLASH_TOL[dtype]
                    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                        raise AssertionError(
                            f"flash_attention differs from attention_ref: {shape} {dtype} "
                            f"causal={causal} strided={strided}, max abs {d}")
                    err[dtype] = max(err[dtype], d)
                    n_cases += 1
    log(f"flash_attention: within 2e-5 (f32) / 2e-2 (bf16) of attention_ref on "
        f"{n_cases} cases (contiguous and strided); max abs err {err}")

    B, Hq, Hkv, S, D = PREFILL_SHAPE
    prefill, inputs = check_flash_prefill(gen)
    log(f"flash_attention {PREFILL_SHAPE} causal vs attention_ref: "
        + "; ".join(f"{dt} max abs {r['max_abs']:.3e}, relative L2 {r['rel_l2']:.3e}, "
                    f"worst |d| / (atol + rtol |want|) {r['worst_ratio']:.3f} "
                    f"(atol, rtol {PREFILL_TOL[dt]})" for dt, r in prefill.items()))
    # operations: QK^T and P.V over the S(S+1)/2 unmasked (q, kv) pairs of
    # each head, 2 FLOP per multiply-add (the split halves' extra products
    # are not counted as work: bf16's P_lo.V pass; f32's three TF32 products
    # count as three); bytes: q, k, v read once, o written once
    n_ops = 4 * B * Hq * D * S * (S + 1) / 2
    n_elems = 2 * B * Hq * S * D + 2 * B * Hkv * S * D
    q32, k32, v32 = inputs.pop("float32")
    f32_call = lambda: ops.flash_attention_cuda(q32, k32, v32, causal=True)  # noqa: E731
    tf32_ms = cuda_ms(f32_call, iters=10, warmup=2)
    tf32_dev_us = _kernel_device_us(f32_call, 3, "flash_tf32_kernel")
    # the FMA kernel this one replaced, and the f32 yardstick: SDPA on the
    # same f32 views (TF32 off, exact_f32)
    fma_ms = cuda_ms(lambda: ops.flash_attention_fma(q32, k32, v32, causal=True), iters=3,
                     warmup=1)
    sdpa_f32 = cuda_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32, is_causal=True,
                                                              enable_gqa=True),
                       iters=3, warmup=1)
    tf32_again = cuda_ms(f32_call, iters=10, warmup=2)  # kernel, yardsticks, kernel
    plain_f32 = cuda_ms(lambda: ops.attention_ref(q32, k32, v32, causal=True), iters=2,
                        warmup=1)
    tf32_bound, tf32_by = bound_ms(4 * n_elems, 3 * n_ops, TF32_TENSOR_OPS_PER_S)
    fma_bound, fma_by = bound_ms(4 * n_elems, n_ops)
    del q32, k32, v32
    torch.cuda.empty_cache()
    q, k, v = inputs.pop("bfloat16")
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: ops.flash_attention_cuda(q, k, v, causal=True), iters=20, warmup=3)
    dev_us = _kernel_device_us(lambda: ops.flash_attention_cuda(q, k, v, causal=True), 5,
                               "flash_tc_kernel")
    plain = cuda_ms(lambda: ops.attention_ref(q, k, v, causal=True), iters=2, warmup=1)
    torch.cuda.empty_cache()
    library = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True),
                      iters=20, warmup=3)
    b, by = bound_ms(2 * n_elems, n_ops, BF16_TENSOR_OPS_PER_S)
    log(f"flash_attention {PREFILL_SHAPE} bf16 causal: tensor-core kernel {ms:.4f} ms "
        f"({n_ops / ms * 1e-9:.2f} TFLOP/s; {dev_us} us device per launch), plain "
        f"{plain:.4f} ms, scaled_dot_product_attention {library:.4f} ms "
        f"({ms / library:.2f}x its time), bound {b:.6f} ms ({by})")
    log(f"flash_attention {PREFILL_SHAPE} f32 causal: 3xTF32 kernel {tf32_ms:.4f} ms, "
        f"{tf32_again:.4f} ms after the yardsticks ({n_ops / tf32_ms * 1e-9:.2f} TFLOP/s of "
        f"attention; {tf32_dev_us} us device per launch), its 3xTF32 bound "
        f"{tf32_bound:.6f} ms ({tf32_by}, {100 * tf32_bound / tf32_ms:.2f}% of it), the FMA "
        f"bound {fma_bound:.6f} ms ({fma_by}, {100 * fma_bound / tf32_ms:.2f}%); in the "
        f"same call the FMA kernel it replaced {fma_ms:.4f} ms, scaled_dot_product_attention "
        f"in f32 {sdpa_f32:.4f} ms, plain {plain_f32:.4f} ms")
    max_abs = {dt: max(err[dt], prefill[dt]["max_abs"]) for dt in prefill}
    prefill["timing"] = {"tc_ms": ms, "tc_tflops": n_ops / ms * 1e-9,
                         "tc_device_us_per_launch": dev_us, "plain_ms": plain,
                         "sdpa_ms": library, "bound_ms": b, "tf32_ms": [tf32_ms, tf32_again],
                         "tf32_device_us_per_launch": tf32_dev_us,
                         "tf32_bound_ms": tf32_bound, "fma_f32_ms": fma_ms,
                         "fma_f32_bound_ms": fma_bound, "sdpa_f32_ms": sdpa_f32,
                         "plain_f32_ms": plain_f32}
    bf16 = {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:72",
            "launches": None, "max_abs_err": max_abs["bfloat16"], "ms": ms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by, "library_ms": library,
            "dtype": "bfloat16"}
    f32 = {"name": "flash_attention_f32", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_sm90_f32.cu",
           "replaces": "src/repro/kernels/flash_attention/flash_attention.py:72",
           "launches": None, "max_abs_err": max_abs["float32"], "ms": tf32_ms,
           "plain_ms": plain_f32, "bound_ms": tf32_bound, "bound_by": tf32_by,
           "library_ms": sdpa_f32, "dtype": "float32", "device_us": tf32_dev_us,
           "fma_bound_ms": fma_bound, "fma_kernel_ms": fma_ms}
    return [bf16, f32], prefill


# the two-tower pooling at serve_p99 and serve_bulk: N history rows of
# D = 256 into B bags of 50 (phase 8's shapes); and an unsorted scatter, the
# kernel's GNN use: 2^24 rows of D = 64, Zipf(1.2) ids over 2^20 segments
SEGSUM_SERVE = ((25_600, 256, 512), (13_107_200, 256, 262_144))
SEGSUM_SCATTER = (1 << 24, 64, 1 << 20)
SEGSUM_TABLE_ROWS = 1_000_000  # the op-level comparison's table
SEGSUM_RTOL = 1e-5  # and atol 1e-5 * max|want|: f32 sums taken in other orders


def _segsum_error(got, want, exact: bool = False) -> float:
    """Max |got - want|; raises unless within rtol 1e-5 and atol 1e-5 *
    max|want| (equal where ``exact``)."""
    import torch

    d = (got - want).abs()
    err = float(d.max()) if d.numel() else 0.0
    if exact:
        ok = torch.equal(got, want)
    else:
        atol = SEGSUM_RTOL * (float(want.abs().max()) if want.numel() else 0.0)
        ok = bool((d <= atol + SEGSUM_RTOL * want.abs()).all())
    if not (ok and bool(torch.isfinite(got).all())):
        raise AssertionError(f"max abs err {err}" + (" (must be exact)" if exact else ""))
    return err


def _segsum_case(ops, vals, seg, S: int, what: str, exact: bool = False) -> float:
    """The kernel twice (bit-identical) against the plain version."""
    import torch

    got = ops.segment_sum_cuda(vals, seg, n_segments=S)
    again = ops.segment_sum_cuda(vals, seg, n_segments=S)
    want = ops.segment_sum_ref(vals, seg, n_segments=S)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sum {what}: two launches differ")
    try:
        return _segsum_error(got, want, exact)
    except AssertionError as e:
        raise AssertionError(f"segment_sum {what}: {e}") from None


def check_segment_sum(device, rng) -> tuple[dict, dict]:
    """Phase 2d, the generic op: the kernel's entry for the ``kernels`` line
    (at serve_bulk's shape; its launches are those of the Zipf scatter driven
    through ``ops.segment_sum``), and the readings at both serving shapes."""
    import numpy as np
    import torch
    from repro_torch.data.streams import zipf_keys
    from repro_torch.kernels.embedding_bag import ops

    def put(a, dtype=None):
        t = torch.from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)

    n_cases, err = 0, 0.0
    # the reference test space, ids sorted and not
    for N in (1, 255, 257, 1000, 2000):
        for D in (8, 64, 256):
            for S in (4, 128, 1024):
                vals = put(rng.normal(size=(N, D)).astype(np.float32))
                segs = rng.integers(0, S, N)
                for order in ("unsorted", "sorted"):
                    seg = put((np.sort(segs) if order == "sorted" else segs).astype(np.int32))
                    err = max(err, _segsum_case(ops, vals, seg, S, f"N={N} D={D} S={S} {order}"))
                    n_cases += 1
    # tests/test_kernels.py's unsorted case with empty segments: exact
    _segsum_case(ops, put(np.ones((512, 16), np.float32)),
                 put(np.tile([7, 3, 7, 0], 128).astype(np.int32)), 10, "tile([7,3,7,0])",
                 exact=True)
    vals = put(rng.normal(size=(3000, 64)).astype(np.float32))
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    cases = [("mostly empty segments", vals[:100], i32(rng.integers(0, 5000, 100)), 5000),
             ("negative ids and ids >= S", vals, i32(rng.integers(-300, 1300, 3000)), 1000),
             ("sorted, out of range at both ends", vals,
              i32(np.sort(rng.integers(-300, 1300, 3000))), 1000),
             ("all rows dropped", vals, i32(np.full(3000, -1)), 1000),
             ("bf16 rows", vals.bfloat16(), i32(rng.integers(0, 700, 3000)), 700),
             ("f16 rows", vals.half(), i32(rng.integers(0, 700, 3000)), 700),
             ("ragged D=3", vals[:, :3], i32(rng.integers(0, 50, 3000)), 50),
             ("int64 ids", vals, rng.integers(0, 700, 3000).astype(np.int64), 700)]
    for what, v, segs, S in cases:
        err = max(err, _segsum_case(ops, v, put(segs), S, what))
    ints = put(rng.integers(-50, 51, (65536, 64)).astype(np.float32))
    _segsum_case(ops, ints, put(rng.integers(0, 1000, 65536).astype(np.int32)), 1000,
                 "integer-valued rows", exact=True)
    n_cases += len(cases) + 2
    # the generic op's path, the kernel's GNN use: an unsorted scatter whose
    # Zipf-hot segments hold millions of rows, through ops.segment_sum
    N, D, S = SEGSUM_SCATTER
    vals = torch.randn((N, D), generator=torch.Generator(device=device).manual_seed(1),
                       device=device)
    seg = put(zipf_keys(rng, N, 1.2, S).astype(np.int32))
    t0 = time.perf_counter()
    ops.segment_sum_cuda.launches = 0
    got = ops.segment_sum(vals, seg, n_segments=S)
    if ops.segment_sum_cuda.launches != 1:
        raise AssertionError(f"ops.segment_sum on CUDA tensors launched the kernel "
                             f"{ops.segment_sum_cuda.launches} times, not once")
    again = ops.segment_sum_cuda(vals, seg, n_segments=S)
    want = ops.segment_sum_ref(vals, seg, n_segments=S)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("segment_sum scatter: two launches differ")
    err = max(err, _segsum_error(got, want))
    scatter_s = time.perf_counter() - t0
    del vals, seg, got, again, want
    torch.cuda.empty_cache()
    log(f"segment_sum: {n_cases + 1} cases within rtol {SEGSUM_RTOL} / atol 1e-5 max|want| "
        f"of the plain version (integer-valued ones exact), two launches bit-identical each; "
        f"max abs err {err:.3e}; the Zipf scatter (N={N}, D={D}, S={S}) through "
        f"ops.segment_sum, one launch, checked in {scatter_s:.2f} s")

    readings = {}
    for N, D, S in SEGSUM_SERVE:
        vals = torch.randn((N, D), generator=torch.Generator(device=device).manual_seed(N),
                           device=device).mul_(0.01)
        seg = torch.arange(S, device=device, dtype=torch.int32).repeat_interleave(N // S)
        case_err = _segsum_case(ops, vals, seg, S, f"serving shape N={N}")
        err = max(err, case_err)
        it = (10, 3) if N > 1_000_000 else (200, 20)
        ms = cuda_ms(lambda: ops.segment_sum_cuda(vals, seg, n_segments=S), *it)
        plain = cuda_ms(lambda: ops.segment_sum_ref(vals, seg, n_segments=S), *it)
        seg64 = seg.long()
        library = cuda_ms(lambda: torch.zeros((S, D), device=device).index_add_(0, seg64, vals),
                          *it)
        prof = _device_profile(lambda: ops.segment_sum_cuda(vals, seg, n_segments=S), 5,
                               "segment_sum_kernel")
        dev_us = prof["kernel_device_us_per_launch"]
        # bytes: the rows and the ids read once, out written once (f32)
        b, by = bound_ms(4 * N * D + 4 * N + 4 * S * D, N * D)
        readings[f"N={N}"] = {
            "N": N, "D": D, "S": S, "max_abs_err": case_err, "ms": ms, "plain_ms": plain,
            "index_add_ms": library, "device_us_per_launch": dev_us, "profile": prof,
            "bound_ms": b, "bound_by": by}
        log(f"segment_sum N={N} D={D} S={S} (sorted bags): kernel {ms:.4f} ms per call "
            f"({dev_us} us device per launch), plain {plain:.4f} ms, index_add_ "
            f"{library:.4f} ms, bound {b:.6f} ms ({by})")
        del vals, seg, seg64
        torch.cuda.empty_cache()
    bulk = readings[f"N={SEGSUM_SERVE[-1][0]}"]
    return {"name": "segment_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
            "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:52",
            "launches": None, "max_abs_err": err, "ms": bulk["ms"],
            "plain_ms": bulk["plain_ms"], "bound_ms": bulk["bound_ms"],
            "bound_by": bulk["bound_by"], "library_ms": bulk["index_add_ms"]}, readings


BAG_SLICE = 65_536  # bags per call of the plain version at the serving shapes


def _bag_plain(ops, table, ids, S: int, L: int, mode: str = "mean"):
    """``embedding_bag_ref`` over bags of L consecutive ids (bag b = ids
    b*L .. b*L + L - 1), BAG_SLICE bags per call: it gathers every row in
    f32 and sums them in f64, [N, D] three times over."""
    import torch

    outs = []
    for lo in range(0, S, BAG_SLICE):
        hi = min(S, lo + BAG_SLICE)
        bags = torch.arange(hi - lo, device=ids.device)[:, None].expand(hi - lo, L).reshape(-1)
        outs.append(ops.embedding_bag_ref(table, ids[lo * L:hi * L], bags, n_bags=hi - lo,
                                          mode=mode))
    return torch.cat(outs)


def _gather_segment_sum(ops, table, ids, bags, S: int):
    """The composition ``ops.embedding_bag`` ran before the fused kernel, as
    a yardstick (mode "mean"): drop the padding (a host sync), gather the
    rows into a new [N, D] array, ``segment_sum`` them, then a column of
    ones for the counts."""
    import torch

    kept = (ids >= 0).nonzero().squeeze(1)
    rows = table[ids[kept].clamp(max=table.shape[0] - 1)]
    segs = bags[kept]
    out = ops.segment_sum(rows, segs, n_segments=S)
    ones = torch.ones((rows.shape[0], 1), dtype=torch.float32, device=rows.device)
    del rows
    return out.div_(ops.segment_sum(ones, segs, n_segments=S).clamp_(min=1.0))


def _bag_case(ops, device, rng, D: int, dtype, order: str, mode: str, weights) -> float:
    """The fused kernel twice (bit-identical) against ``embedding_bag_ref``
    on 64 bags of 0..40 ids over a 1000-row table: 10% padding, a bag of
    padding only, empty bags, ids past the table, bag ids out of range at
    both ends; ``order`` "promised" (sorted, and the caller says so),
    "sorted" or "unsorted"; ``weights`` None, "table" (the table's dtype:
    products rounded to it) or "f32"."""
    import numpy as np
    import torch

    V, B = 1000, 64
    lengths = rng.integers(0, 41, B)
    lengths[[3, 17]] = 0
    bags = np.concatenate([np.full(7, -1), np.repeat(np.arange(B), lengths), np.full(5, B)])
    ids = rng.integers(0, V + 50, len(bags))
    ids[rng.random(len(bags)) < 0.1] = -1
    ids[bags == 5] = -1
    if order == "unsorted":
        p = rng.permutation(len(bags))
        bags, ids = bags[p], ids[p]
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(device).to(dtype)
    w = torch.from_numpy((rng.random(len(bags)) + 0.5).astype(np.float32)).to(device)
    w = None if weights is None else w.to(dtype) if weights == "table" else w
    ids = torch.from_numpy(ids).to(device)
    bags = torch.from_numpy(bags.astype(np.int32)).to(device)
    kw = dict(n_bags=B, mode=mode, per_sample_weights=w, sorted_bags=order == "promised")
    got = ops.embedding_bag_cuda(table, ids, bags, **kw)
    again = ops.embedding_bag_cuda(table, ids, bags, **kw)
    want = ops.embedding_bag_ref(table, ids, bags, n_bags=B, mode=mode, per_sample_weights=w)
    torch.cuda.synchronize()
    what = f"embedding_bag D={D} {dtype} {order} {mode} weights={weights}"
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")
    if got[[3, 5, 17]].any():
        raise AssertionError(f"{what}: an empty or padding-only bag is not zero")
    try:
        return _segsum_error(got, want)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def check_embedding_bag(device, rng) -> tuple[dict, dict]:
    """Phase 2d, the gather-fused ``embedding_bag`` kernel against
    ``embedding_bag_ref``: small cases, integer rows exactly, and both
    serving shapes; at those shapes it is timed beside the plain version,
    ``F.embedding_bag(mode="mean", padding_idx=0)`` and the gather ->
    ``segment_sum`` composition it replaces.  Returns the kernel's entry for
    the ``kernels`` line (at serve_bulk's shape) and the readings."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.data.streams import zipf_keys
    from repro_torch.kernels.embedding_bag import ops

    n_cases, err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (3, 8, 64, 256):
            for mode, weights in (("sum", None), ("mean", None), ("sum", "table"),
                                  ("mean", "f32")):
                for order in ("promised", "sorted", "unsorted"):
                    err = max(err, _bag_case(ops, device, rng, D, dtype, order, mode, weights))
                    n_cases += 1
    table = torch.from_numpy(rng.integers(-50, 51, (3000, 256)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(-1, 3000, 40_000)).to(device)
    bags = torch.from_numpy(np.sort(rng.integers(0, 700, 40_000))).to(device)
    for mode in ("sum", "mean"):
        got = ops.embedding_bag_cuda(table, ids, bags, n_bags=700, mode=mode, sorted_bags=True)
        if not torch.equal(got, ops.embedding_bag_ref(table, ids, bags, n_bags=700, mode=mode)):
            raise AssertionError(f"embedding_bag {mode} on integer-valued rows is not exact")
        n_cases += 1
    log(f"embedding_bag: {n_cases} cases within rtol {SEGSUM_RTOL} / atol 1e-5 max|want| of "
        f"embedding_bag_ref (integer-valued ones exact), two launches bit-identical each; "
        f"max abs err {err:.3e}")

    readings = {}
    V = SEGSUM_TABLE_ROWS
    for N, D, S in SEGSUM_SERVE:
        L = N // S
        # the two-tower pooling over a 1M-row table (Zipf ids, 10% padding),
        # its bags as history_pool makes them
        table = torch.randn((V, D), generator=torch.Generator(device=device).manual_seed(V),
                            device=device).mul_(0.01)
        hist = torch.from_numpy(zipf_keys(rng, N, 1.2, V)).to(device)
        hist[torch.from_numpy(rng.random(N) < 0.1).to(device)] = 0
        ids = torch.where(hist > 0, hist, -1)
        bags = torch.arange(S, device=device)[:, None].expand(S, L).reshape(-1)
        offsets = torch.arange(0, N, L, device=device)

        def fused():
            return ops.embedding_bag_cuda(table, ids, bags, n_bags=S, mode="mean",
                                          sorted_bags=True)
        got, again = fused(), fused()
        want = _bag_plain(ops, table, ids, S, L)
        lib = F.embedding_bag(hist, table, offsets, mode="mean", padding_idx=0)
        old = _gather_segment_sum(ops, table, ids, bags, S)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"embedding_bag serving shape N={N}: two launches differ")
        try:
            case_err = _segsum_error(got, want)
        except AssertionError as e:
            raise AssertionError(f"embedding_bag serving shape N={N}: {e}") from None
        err = max(err, case_err)
        lib_err, old_err = float((got - lib).abs().max()), float((got - old).abs().max())
        del want, lib, old
        torch.cuda.empty_cache()
        it = (10, 3) if N > 1_000_000 else (200, 20)
        ms = cuda_ms(fused, *it)
        op_ms = cuda_ms(lambda: ops.embedding_bag(table, ids, bags, n_bags=S, mode="mean"), *it)
        lib_ms = cuda_ms(lambda: F.embedding_bag(hist, table, offsets, mode="mean",
                                                 padding_idx=0), *it)
        old_ms = cuda_ms(lambda: _gather_segment_sum(ops, table, ids, bags, S), *it)
        plain = cuda_ms(lambda: _bag_plain(ops, table, ids, S, L), 2, 1)
        prof = _device_profile(fused, 5, "embedding_bag_kernel")
        dev_us = prof["kernel_device_us_per_launch"]
        lib_dev_us = 1e3 * _device_profile(
            lambda: F.embedding_bag(hist, table, offsets, mode="mean", padding_idx=0), 5,
            "")["device_busy_ms_per_call"]
        # the bound: each distinct row the bags name read once, the ids and
        # the bag ids read once, out written once.  Beside it, the bound with
        # every non-padding id counted as a row read from memory, which Zipf
        # ids repeat and L2 serves, so the kernel may beat it
        valid = ids[ids >= 0]
        n_valid, n_unique = int(valid.numel()), int(torch.unique(valid).numel())
        io = ids.numel() * ids.element_size() + bags.numel() * bags.element_size() + 4 * S * D
        b, by = bound_ms(4 * D * n_unique + io, n_valid * D)
        b_all, _ = bound_ms(4 * D * n_valid + io, n_valid * D)
        readings[f"N={N}"] = {
            "N": N, "D": D, "S": S, "table_rows": V, "non_padding_ids": n_valid,
            "distinct_ids": n_unique, "max_abs_err": case_err, "ms": ms,
            "device_us_per_launch": dev_us, "share_of_bound": b * 1e3 / dev_us,
            "share_of_all_rows_bound": b_all * 1e3 / dev_us, "bound_ms": b,
            "bound_by": by, "all_rows_bound_ms": b_all, "plain_ms": plain,
            "op_ms": op_ms, "F_embedding_bag_mean_ms": lib_ms,
            "F_embedding_bag_device_us": lib_dev_us, "gather_segment_sum_ms": old_ms,
            "max_abs_diff_vs_F_embedding_bag": lib_err,
            "max_abs_diff_vs_gather_segment_sum": old_err, "profile": prof}
        log(f"embedding_bag N={N} D={D} S={S} over a {V}-row table ({n_valid} non-padding "
            f"ids, {n_unique} distinct): fused kernel {ms:.4f} ms per call, {dev_us} us device "
            f"per launch, {100 * b * 1e3 / dev_us:.2f}% of its bound {b:.6f} ms ({by}, the "
            f"distinct rows), {100 * b_all * 1e3 / dev_us:.2f}% of the bound over all "
            f"non-padding rows {b_all:.6f} ms; "
            f"ops.embedding_bag (sortedness test) {op_ms:.4f} ms; F.embedding_bag(mean, "
            f"padding_idx=0) {lib_ms:.4f} ms ({lib_dev_us} us device); gather -> segment_sum "
            f"{old_ms:.4f} ms; plain {plain:.4f} ms; max abs diff vs F.embedding_bag "
            f"{lib_err:.3e}, vs gather -> segment_sum {old_err:.3e}")
        del table, hist, ids, bags, offsets, got, again, valid
        torch.cuda.empty_cache()
    bulk = readings[f"N={SEGSUM_SERVE[-1][0]}"]
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:52",
            "launches": None, "max_abs_err": err, "ms": bulk["ms"],
            "plain_ms": bulk["plain_ms"], "bound_ms": bulk["bound_ms"],
            "bound_by": bulk["bound_by"], "library_ms": bulk["F_embedding_bag_mean_ms"],
            "device_us": bulk["device_us_per_launch"],
            "all_rows_bound_ms": bulk["all_rows_bound_ms"]}, readings


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
    from repro_torch.data.streams import zipf_keys
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
    n_sorts = check_ingest_sorts(keys, batch)
    if n_sorts != launches["chunksort"]:
        raise AssertionError(f"the replayed ingest made {n_sorts} sorts, the timed one "
                             f"{launches['chunksort']}")
    log(f"chunksort bit-identical to torch.sort(stable=True) at all {n_sorts} ingest sorts "
        f"(the same stream ingested again, untimed)")
    return out


def check_ingest_sorts(keys, batch: int) -> int:
    """Phase 3's ingest again, untimed, on a fresh service over the same
    stream: each chunk's sort is held against ``torch.sort(stable=True)`` as
    it is made (a device count of the sorts that differ, read once at the
    end).  Returns the number of sorts."""
    import torch
    from repro_torch.kernels.chunksort import ops as sops
    from repro_torch.stats.service import StatsConfig, StreamStatsService

    sort_with_perm = sops.sort_with_perm
    differ = torch.zeros((), dtype=torch.long, device="cuda")
    n_sorts = 0

    def checked_sort(k):
        nonlocal differ, n_sorts
        ks, perm = sort_with_perm(k)
        want_ks, want_perm = sops.sort_with_perm_ref(k)
        differ = differ + ((ks != want_ks).any() | (perm != want_perm).any()).long()
        n_sorts += 1
        return ks, perm

    svc = StreamStatsService(StatsConfig())
    sops.sort_with_perm = checked_sort
    try:
        for lo in range(0, len(keys), batch):
            svc.observe(keys[lo:lo + batch])
    finally:
        sops.sort_with_perm = sort_with_perm
    if int(differ):
        raise AssertionError(f"chunksort differs from torch.sort(stable=True) in "
                             f"{int(differ)} of {n_sorts} ingest sorts")
    return n_sorts


def run_state_round_trip(seed: int, n: int) -> None:
    import numpy as np
    from repro_torch.core import segments
    from repro_torch.data.streams import zipf_keys
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
    from repro_torch.data.streams import zipf_keys
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
            for name, tag in (("chunksort", "sort_chunk"),
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


def _counted(fn, barrier=True):
    """``(fn(), seconds, launches)``: every kernel count set to 0 just
    before ``fn`` and read just after."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out, sec = _synced(fn, barrier)
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
    from repro_torch.data.streams import zipf_keys
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
    from repro_torch.core import distributed as DZ
    from repro_torch.core import freqfns, segments
    from repro_torch.stats.service import StreamStatsService

    ranks = [o for o, _ in gathered]
    P, m = len(ranks), len(keys) // len(ranks)
    for o in ranks:
        if o["digest"] != ranks[0]["digest"]:
            raise AssertionError(f"rank {o['rank']}'s program result differs from rank 0's")
        # pass I scores the shard in launches of whole chunks, SCORE_BATCH
        # elements at most (pass1_local_multi through capscore_multi)
        score_launches = -(-o["steps"] // max(1, DZ.SCORE_BATCH // cfg.chunk))
        for merge in ("tree", "allgather"):
            la = o[f"launches_{merge}"]
            if la["capscore_multi"] != score_launches:
                raise AssertionError(f"rank {o['rank']} merge={merge}: capscore_multi "
                                     f"launched {la['capscore_multi']} times for a shard "
                                     f"of {m} elements, not {score_launches}")
        # and so does the single-l program, through capscore
        if o["launches_single"]["capscore"] != score_launches:
            raise AssertionError(f"rank {o['rank']}: capscore launched "
                                 f"{o['launches_single']['capscore']} times for a shard of "
                                 f"{m} elements, not {score_launches}")
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


# ---------------------------------------------------------------------------
# phase 7: dense LM serving at full width
# ---------------------------------------------------------------------------

LM_BATCH, LM_PROMPT, LM_NEW = 4, 4096, 32  # 4 prompts of Yi-6B's 4096-token context
# Both sides of each check run the same bf16 model and differ only in how
# attention orders its f32 sums (and, for decode, in the matmul shapes and the
# softmax weights rounded to bf16 as the reference does); each such difference
# can flip a bf16 rounding (2^-8 relative) that 32 residual layers of a
# random-weight model carry into every logit, a few per cent of the vector:
# 0.0174 (prefill logits) and 0.0185 (decode) for the kernel, 0.151 for it
# with one kv tile dropped on the rows past 2048 (flash_fault_check.py,
# PERF.md, PR 13).  In f32 the two paths differ by sum orders alone: 4.6e-6
# for the kernel, 0.149 with the dropped tile.
LM_REL_L2_TOL = 5e-2
LM_F32_REL_L2_TOL = 1e-3


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _hold_prefill(out: dict, failures: list, tag: str, got, want, tol: float) -> None:
    """Relative L2 of a prefill's (logits, k cache, v cache) against the
    plain path's, into ``out``; a non-finite value or one above ``tol``
    goes to ``failures``."""
    import torch

    for name, g, w in zip(("logits", "k_cache", "v_cache"), got, want):
        rel = out[f"{tag}_{name}_rel_l2"] = _rel_l2(g, w)
        if not (torch.isfinite(g).all() and rel <= tol):
            failures.append(f"{tag} {name} through the kernel vs the plain path: relative "
                            f"L2 {rel} > {tol} (or non-finite)")


def _all_counters():
    from repro_torch.kernels.flash_attention import ops as fops

    return {**_counters(), "flash_attention": fops.flash_attention_cuda}


def run_lm_serving(seed: int, device) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import yi_6b
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cfg = dataclasses.replace(yi_6b.full_config(), attention_backend=None)
    plain = dataclasses.replace(cfg, attention_backend="xla_chunked")
    B, S, NEW = LM_BATCH, LM_PROMPT, LM_NEW
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": str(cfg.dtype), "batch": B, "prompt": S, "new_tokens": NEW}
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    sync()
    out["init_s"] = time.perf_counter() - t0
    out["n_params"] = sum(t.numel() for t in _leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S))).to(device)
    T.prefill(params, cfg, tokens[:, :128])  # warm-up: libraries and kernels loaded

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = _all_counters()
    flash = counters["flash_attention"]

    def reset_counters():
        for c in counters.values():
            c.launches = 0
        flash.launches_tc = flash.launches_tf32 = flash.launches_fma = 0

    def routes():
        return {"flash_attention_tc": flash.launches_tc,
                "flash_attention_tf32": flash.launches_tf32,
                "flash_attention_fma": flash.launches_fma}

    def hold_routes(what: str, want: dict) -> None:
        """The prefill's launches of the bf16 and the 3xTF32 tensor-core
        kernel and of the FMA kernel."""
        if routes() != want:
            failures.append(f"{what}: launches {routes()}, want {want} in a prefill of "
                            f"{cfg.n_layers} layers")

    reset_counters()
    sync()
    t0 = time.perf_counter()
    logits, (ck, cv) = T.prefill(params, cfg, tokens)
    sync()
    t_prefill = time.perf_counter() - t0
    out["launches"] = {name: c.launches for name, c in counters.items()}
    out["launches"].update(routes())
    failures = []
    hold_routes("bf16 prefill", {"flash_attention_tc": cfg.n_layers, "flash_attention_tf32": 0,
                                 "flash_attention_fma": 0})
    out.update(prefill_ms=t_prefill * 1e3, prefill_tokens_per_s=B * S / t_prefill,
               max_memory_allocated_prefill=(torch.cuda.max_memory_allocated()
                                             if device.type == "cuda" else None))
    if device.type == "cuda":
        prof = out["prefill_profile"] = _device_profile(
            lambda: T.prefill(params, cfg, tokens), 1, "flash_tc_kernel",
            ("flash_tf32_kernel", "flash_kernel"))
        if (prof["tag_launches_per_call"] != cfg.n_layers
                or any(prof["other_launches_per_call"].values())):
            failures.append(f"bf16 prefill profile: {prof['tag_launches_per_call']} launches "
                            f"of flash_tc_kernel, {prof['other_launches_per_call']} of the "
                            f"f32 kernels (want {cfg.n_layers} and none)")

    sync()
    t0 = time.perf_counter()
    p_logits, (p_ck, p_cv) = T.prefill(params, plain, tokens)
    sync()
    out["plain_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    _hold_prefill(out, failures, "prefill", (logits, ck, cv), (p_logits, p_ck, p_cv),
                  LM_REL_L2_TOL)
    out["prefill_logits_max_abs_diff"] = float((logits - p_logits).abs().max())
    del p_logits, p_ck, p_cv

    cache = T.init_cache(cfg, B, S + NEW, device=device)
    cache[0][:, :, :S] = ck
    cache[1][:, :, :S] = cv
    del ck, cv
    tok = logits.argmax(dim=-1)
    fed = []
    sync()
    t0 = time.perf_counter()
    for t in range(NEW):
        fed.append(tok)
        pos = torch.full((B,), S + t, dtype=torch.long, device=device)
        step_logits, cache = T.decode_step(params, cfg, tok, cache, pos)
        tok = step_logits.argmax(dim=-1)
    sync()
    t_dec = time.perf_counter() - t0
    out.update(decode_ms_per_step=t_dec / NEW * 1e3, decode_tokens_per_s=B * NEW / t_dec)

    # the same tokens through one plain prefill; 4128 is no multiple of 512,
    # so the chunked path takes 8 chunks of 516 rows
    full = torch.cat([tokens, torch.stack(fed, dim=1)], dim=1)
    f_logits, _ = T.prefill(params, dataclasses.replace(plain, attention_chunk=(S + NEW) // 8),
                            full)
    rel = _rel_l2(step_logits, f_logits)
    out["decode_vs_full_prefill_rel_l2"] = rel
    out["decode_vs_full_prefill_max_abs_diff"] = float((step_logits - f_logits).abs().max())
    out["decode_vs_full_prefill_argmax_equal"] = int(
        (step_logits.argmax(-1) == f_logits.argmax(-1)).sum())
    if not (torch.isfinite(step_logits).all() and rel <= LM_REL_L2_TOL):
        failures.append(f"last decode step vs a plain prefill of all {S + NEW} tokens: "
                        f"relative L2 {rel} > {LM_REL_L2_TOL} (or non-finite)")
    del f_logits, full
    if device.type == "cuda":  # the last step again: it rewrites the same k/v
        out["decode_profile"] = _device_profile(
            lambda: T.decode_step(params, cfg, fed[-1], cache, pos), 4, "flash_tc_kernel")
    del cache

    server = serve.DecodeServer(cfg, params, slots=4, max_len=24 + 16, device=device)
    counters["flash_attention"].launches = 0
    sync()
    res = serve.serve(server, serve.demo_prompts(6, cfg.vocab, seed), log=lambda m: None)
    sync()
    if sorted(server.outputs) != list(range(6)) or not all(server.outputs.values()):
        failures.append(f"DecodeServer answered {sorted(server.outputs)} of 6 requests")
    out["server"] = {**res, "tokens_per_s": res["tokens"] / res["seconds"],
                     "flash_attention_launches": counters["flash_attention"].launches}
    del server

    # the same weights in f32: the two paths then differ by f32 sum orders
    # only, and a fault the bf16 gate cannot see stands out
    params = T.tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    reset_counters()
    f32_out = []
    if device.type == "cuda":  # the checked prefill itself, profiled
        prof32 = out["f32_prefill_profile"] = _device_profile(
            lambda: f32_out.append(T.prefill(params, cfg32, tokens)), 1, "flash_tf32_kernel",
            ("flash_tc_kernel", "flash_kernel"))
        if (prof32["tag_launches_per_call"] != cfg.n_layers
                or any(prof32["other_launches_per_call"].values())):
            failures.append(f"f32 prefill profile: {prof32['tag_launches_per_call']} launches "
                            f"of flash_tf32_kernel, {prof32['other_launches_per_call']} of the "
                            f"others (want {cfg.n_layers} and none)")
    else:
        f32_out.append(T.prefill(params, cfg32, tokens))
    got = (f32_out[0][0], *f32_out[0][1])
    del f32_out
    out["launches_f32_prefill"] = routes()
    hold_routes("f32 prefill", {"flash_attention_tc": 0, "flash_attention_tf32": cfg.n_layers,
                                "flash_attention_fma": 0})
    want = T.prefill(params, dataclasses.replace(plain, dtype=torch.float32), tokens)
    _hold_prefill(out, failures, "f32_prefill", got, (want[0], *want[1]), LM_F32_REL_L2_TOL)
    del got, want, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prof = out.get("prefill_profile", {})
    dprof = out.get("decode_profile", {})
    prof32 = out.get("f32_prefill_profile", {})
    log(f"phase 7 ({cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
        f"{out['n_params']} parameters, init {out['init_s']:.1f} s): prefill {B}x{S} in "
        f"{out['prefill_ms']:.1f} ms ({out['prefill_tokens_per_s']:.1f} tokens/s, plain path "
        f"{out['plain_prefill_ms']:.1f} ms), max_memory_allocated "
        f"{out['max_memory_allocated_prefill']} B, launches {out['launches']}; attention "
        f"{prof.get('kernel_device_ms_per_call')} ms of "
        f"{prof.get('device_busy_ms_per_call')} ms device time "
        f"({prof.get('kernel_device_us_per_launch')} us per launch, device busy "
        f"{prof.get('device_busy_share')}); decode {out['decode_ms_per_step']:.2f} ms per "
        f"step ({out['decode_tokens_per_s']:.1f} tokens/s; profiled: "
        f"{dprof.get('kernel_launches_per_call')} kernel launches and "
        f"{dprof.get('device_busy_ms_per_call')} ms device time per step, device busy "
        f"{dprof.get('device_busy_share')}); relative L2 vs the plain path: "
        f"prefill logits {out['prefill_logits_rel_l2']:.3e}, k {out['prefill_k_cache_rel_l2']:.3e}, "
        f"v {out['prefill_v_cache_rel_l2']:.3e}, last decode step vs full prefill "
        f"{rel:.3e} (argmax equal {out['decode_vs_full_prefill_argmax_equal']}/{B}); "
        f"f32 copy: prefill logits {out['f32_prefill_logits_rel_l2']:.3e}, k "
        f"{out['f32_prefill_k_cache_rel_l2']:.3e}, v {out['f32_prefill_v_cache_rel_l2']:.3e}, "
        f"launches {out['launches_f32_prefill']}, attention "
        f"{prof32.get('kernel_device_ms_per_call')} ms of {prof32.get('device_busy_ms_per_call')} "
        f"ms device time ({prof32.get('kernel_device_us_per_launch')} us per launch, wall "
        f"{prof32.get('wall_ms_per_call')} ms, profiled); "
        f"DecodeServer: 6 requests, {res['tokens']} tokens in {res['seconds']:.2f} s "
        f"({out['server']['tokens_per_s']:.1f} tokens/s, {res['steps']} steps; token-by-token "
        f"admit and decode only, so flash_attention launched "
        f"{out['server']['flash_attention_launches']} times)")
    if failures:
        raise CheckFailed(failures, out)
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# phase 8: recsys serving at full size
# ---------------------------------------------------------------------------

# the reference's RECSYS_SHAPES (its configs package): serve batches, and one
# user against 2^20 candidates (1M ids padded with repeats)
RECSYS_SERVE = {"serve_p99": 512, "serve_bulk": 262_144}
RETRIEVAL_CANDIDATES, RETRIEVAL_DISTINCT = 1 << 20, 1_000_000
RECSYS_CALLS = 5      # timed calls per shape; the median is kept
PLAIN_SLICE = 16_384  # requests per call of the plain route (it makes [B, S, D] twice)
N_HOT = 4096
# the sketch that picks the hot rows holds 4x as many keys: a sketch of k <=
# n_hot keys makes every sampled key hot, and the estimated hot share 1
HOT_SKETCH_K = 4 * N_HOT


def _plain_pool(items, hist):
    """The reference's formula for the two-tower pooling."""
    from repro_torch.models import recsys as R

    return R.masked_mean(R.embed_lookup(items, hist), hist)


def _timed_calls(fn, sync, calls: int) -> tuple:
    """(last result, median seconds per call) over ``calls`` calls, each
    between synchronisations."""
    import statistics

    secs = []
    for _ in range(calls):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs.append(time.perf_counter() - t0)
    return out, statistics.median(secs)


def _hold(failures: list, what: str, got, want) -> float:
    try:
        return _segsum_error(got.float(), want.float())
    except AssertionError as e:
        failures.append(f"{what}: {e}")
        return float("nan")


def _profile_line(prof: dict) -> str:
    if not prof:
        return "not profiled"
    return (f"profiled: device busy {prof['device_busy_ms_per_call']:.4f} ms per call "
            f"({100 * prof['device_busy_share']:.2f}% of the wall time), "
            f"{prof['kernel_launches_per_call']:.1f} kernel launches per call, "
            f"embedding_bag {prof['kernel_device_ms_per_call']:.4f} ms per call "
            f"({prof['kernel_device_us_per_launch']} us per launch, "
            f"{prof['tag_launches_per_call']} launches per call; segment_sum "
            f"{prof['other_launches_per_call']['segment_sum_kernel']})")


def _topk_cut_ties(failures: list, vals, idx, p_vals, p_idx) -> int:
    """Indices in one top-k only; each must score within tolerance of its
    own side's cut (a tie), else it goes to ``failures``."""
    tol = SEGSUM_RTOL * float(p_vals.abs().max()) + SEGSUM_RTOL * float(p_vals[-1].abs())
    got = dict(zip(idx.tolist(), vals.tolist()))
    want = dict(zip(p_idx.tolist(), p_vals.tolist()))
    diff = set(got) ^ set(want)
    for i in diff:
        score, cut = (got[i], float(vals[-1])) if i in got else (want[i], float(p_vals[-1]))
        if abs(score - cut) > tol:
            failures.append(f"candidate {i} is in one top-k only, {score} against the cut {cut}")
    return len(diff)


def run_recsys_serving(seed: int, device) -> dict:
    """Phase 8: two-tower-retrieval at full size (61.44 GB of f32 tables) at
    serve_p99, serve_bulk and retrieval_cand, each held against the plain
    pooling route; the hot/cold plan from a sketch of the serve_bulk batch's
    item stream; then din, bst and mind at serve_p99."""
    import numpy as np
    import torch
    from repro_torch.configs import bst, din, mind, two_tower_retrieval
    from repro_torch.data.recsys_events import impression_batch, impression_stream_elements
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.models import embedding_sharding as es
    from repro_torch.models import recsys as R
    from repro_torch.stats.service import StatsConfig, StreamStatsService

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def mem():
        return ((torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
                if cuda else (None, None))

    free()
    cfg = two_tower_retrieval.full_config()
    out = {"arch": cfg.name, "n_items": cfg.n_items, "n_users": cfg.n_users,
           "embed_dim": cfg.embed_dim, "n_params": cfg.n_params, "shapes": {}}
    t0 = time.perf_counter()
    params = R.twotower_init(torch.Generator(device=device).manual_seed(seed), cfg)
    sync()
    out["init_s"] = time.perf_counter() - t0
    out["table_bytes"] = sum(params[t].numel() * params[t].element_size()
                             for t in ("items", "users"))
    failures, launches = [], 0
    rng = np.random.default_rng(seed + 8)
    bulk_host = None
    for shape, B in RECSYS_SERVE.items():
        host = impression_batch(rng, batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                n_users=cfg.n_users)
        batch = {k: torch.from_numpy(host[k]).to(device) for k in ("hist", "target", "user_id")}
        R.twotower_serve(params, cfg, batch)  # warm-up
        free()
        if shape == "serve_p99" and cuda:
            # the pooling, where the host is the bottleneck, must not wait for
            # the device: a host sync in it raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                R.history_pool(params["items"], batch["hist"])
            except RuntimeError as e:
                failures.append(f"{shape}: the pooling synchronizes with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync()
        eops.embedding_bag_cuda.launches = eops.segment_sum_cuda.launches = 0
        scores, sec = _timed_calls(lambda: R.twotower_serve(params, cfg, batch), sync,
                                   RECSYS_CALLS)
        n, n_seg = eops.embedding_bag_cuda.launches, eops.segment_sum_cuda.launches
        launches += n
        alloc, reserved = mem()
        if (n, n_seg) != (RECSYS_CALLS, 0):  # one fused launch per call, no segment_sum
            failures.append(f"{shape}: embedding_bag launched {n} times and segment_sum "
                            f"{n_seg} times in {RECSYS_CALLS} calls")
        want = torch.cat([R.twotower_serve(params, cfg, {k: v[i:i + PLAIN_SLICE]
                                                         for k, v in batch.items()},
                                           pool=_plain_pool)
                          for i in range(0, B, PLAIN_SLICE)])
        err = _hold(failures, f"{shape} scores vs the plain route", scores, want)
        if tuple(scores.shape) != (B,):
            failures.append(f"{shape}: scores of shape {tuple(scores.shape)}")
        del want
        prof = (_device_profile(lambda: R.twotower_serve(params, cfg, batch), 3,
                                "embedding_bag_kernel", ("segment_sum_kernel",))
                if cuda else {})
        out["shapes"][shape] = {
            "batch": B, "ms_per_call": sec * 1e3, "requests_per_s": B / sec,
            "embedding_bag_launches_per_call": n / RECSYS_CALLS,
            "max_memory_allocated": alloc, "max_memory_reserved": reserved,
            "max_abs_err_vs_plain": err, "profile": prof}
        log(f"phase 8 {shape} (B={B}): {sec * 1e3:.4f} ms per call (median of "
            f"{RECSYS_CALLS}), {B / sec:.1f} requests/s, embedding_bag launches per call "
            f"{n / RECSYS_CALLS}, max_memory_allocated {alloc} B, reserved {reserved} B; "
            f"max abs err vs the plain route {err:.3e}; {_profile_line(prof)}")
        if shape == "serve_bulk":
            bulk_host = host
        del batch, scores
        free()

    # retrieval_cand: one user against 1M distinct candidates padded to 2^20
    host = impression_batch(rng, batch=1, seq_len=cfg.seq_len, n_items=cfg.n_items,
                            n_users=cfg.n_users)
    cand = rng.permutation(cfg.n_items)[:RETRIEVAL_DISTINCT]
    cand = np.concatenate([cand, cand[:RETRIEVAL_CANDIDATES - RETRIEVAL_DISTINCT]])
    batch = {k: torch.from_numpy(host[k]).to(device) for k in ("hist", "target", "user_id")}
    batch["candidates"] = torch.from_numpy(cand.astype(np.int32)).to(device)
    R.twotower_retrieve(params, cfg, batch)
    free()
    eops.embedding_bag_cuda.launches = eops.segment_sum_cuda.launches = 0
    (vals, idx), sec = _timed_calls(lambda: R.twotower_retrieve(params, cfg, batch), sync,
                                    RECSYS_CALLS)
    n, n_seg = eops.embedding_bag_cuda.launches, eops.segment_sum_cuda.launches
    launches += n
    alloc, reserved = mem()
    if (n, n_seg) != (RECSYS_CALLS, 0):
        failures.append(f"retrieval_cand: embedding_bag launched {n} times and segment_sum "
                        f"{n_seg} times in {RECSYS_CALLS} calls")
    prof = (_device_profile(lambda: R.twotower_retrieve(params, cfg, batch), 3,
                            "embedding_bag_kernel", ("segment_sum_kernel",)) if cuda else {})
    p_vals, p_idx = R.twotower_retrieve(params, cfg, batch, pool=_plain_pool)
    err = _hold(failures, "retrieval_cand top-100 scores vs the plain route", vals, p_vals)
    cut_ties = _topk_cut_ties(failures, vals, idx, p_vals, p_idx)
    out["shapes"]["retrieval_cand"] = {
        "batch": 1, "candidates": RETRIEVAL_CANDIDATES, "ms_per_call": sec * 1e3,
        "requests_per_s": 1 / sec, "candidates_per_s": RETRIEVAL_CANDIDATES / sec,
        "embedding_bag_launches_per_call": n / RECSYS_CALLS, "max_memory_allocated": alloc,
        "max_memory_reserved": reserved, "max_abs_err_vs_plain": err,
        "top100_index_differences_at_tied_cut": cut_ties, "profile": prof}
    log(f"phase 8 retrieval_cand (1 user, {RETRIEVAL_CANDIDATES} candidates, top-100): "
        f"{sec * 1e3:.4f} ms per call, embedding_bag launches per call {n / RECSYS_CALLS}, "
        f"max_memory_allocated {alloc} B, reserved {reserved} B; top-100 max abs err vs the "
        f"plain route {err:.3e}, {cut_ties} indices differ at a tied cut; "
        f"{_profile_line(prof)}")
    del batch, vals, idx, p_vals, p_idx
    free()

    # the paper's loop: a sketch of the serve_bulk item stream picks the hot rows
    _, items = impression_stream_elements(bulk_host)
    svc = StreamStatsService(StatsConfig(k=HOT_SKETCH_K), device=device)
    sync()
    t0 = time.perf_counter()
    for lo in range(0, len(items), 1 << 20):
        svc.observe(items[lo:lo + (1 << 20)])
    sync()
    observe_s = time.perf_counter() - t0
    plan = es.plan_hot_cold(svc, N_HOT)
    hot_table, hot_ids = es.split_table(params["items"], plan)
    exact_frac = float(np.isin(items, plan.hot_ids_sorted).mean())
    hist = bulk_host["hist"]
    for lo in range(0, len(hist), PLAIN_SLICE):
        h = torch.from_numpy(hist[lo:lo + PLAIN_SLICE]).to(device)
        if not torch.equal(es.hot_cold_lookup(params["items"], hot_table, hot_ids, h),
                           R.embed_lookup(params["items"], h)):
            failures.append(f"hot_cold_lookup differs from embed_lookup on requests {lo}+")
            break
    out["hot_cold"] = {"stream_elements": len(items), "sketch_k": HOT_SKETCH_K,
                       "observe_s": observe_s,
                       "elements_per_s": len(items) / observe_s, "n_hot": N_HOT,
                       "est_hot_traffic_frac": plan.est_hot_traffic_frac,
                       "exact_hot_traffic_frac": exact_frac}
    log(f"phase 8 hot/cold: the service (k={HOT_SKETCH_K}) observed the serve_bulk batch's "
        f"{len(items)} item ids in {observe_s:.2f} s ({len(items) / observe_s:.4g} elements/s); "
        f"plan_hot_cold({N_HOT}): estimated hot-traffic share "
        f"{plan.est_hot_traffic_frac:.6f}, exact {exact_frac:.6f}; hot_cold_lookup equals "
        f"embed_lookup on all {hist.size} ids")
    del params, hot_table, hot_ids, svc, bulk_host, hist, items
    free()

    # din, bst and mind at serve_p99
    out["others"] = {}
    B = RECSYS_SERVE["serve_p99"]
    for mod, fn in ((din, R.din_forward), (bst, R.bst_forward), (mind, R.mind_point_serve)):
        mcfg = mod.full_config()
        mparams = R.ARCHS[mod.ARCH_ID][1](torch.Generator(device=device).manual_seed(seed),
                                          mcfg)
        host = impression_batch(rng, batch=B, seq_len=mcfg.seq_len, n_items=mcfg.n_items,
                                n_users=1)
        batch = {k: torch.from_numpy(host[k]).to(device) for k in ("hist", "target")}
        fn(mparams, mcfg, batch)
        scores, sec = _timed_calls(lambda: fn(mparams, mcfg, batch), sync, RECSYS_CALLS)
        finite = bool(torch.isfinite(scores).all())
        if tuple(scores.shape) != (B,) or not finite:
            failures.append(f"{mod.ARCH_ID}: scores of shape {tuple(scores.shape)}, "
                            f"finite {finite}")
        out["others"][mod.ARCH_ID] = {"batch": B, "ms_per_call": sec * 1e3,
                                      "requests_per_s": B / sec}
        log(f"phase 8 {mod.ARCH_ID} at serve_p99 (B={B}): {sec * 1e3:.4f} ms per call, "
            f"scores {tuple(scores.shape)} finite")
        del mparams, batch, scores
        free()
    out["launches"] = {"embedding_bag": launches}
    if failures:
        raise CheckFailed(failures, out)
    return out


# ---------------------------------------------------------------------------
# phase 9: multi-tenant serving (TenantBank, MultiTenantStats, StatsScheduler)
# ---------------------------------------------------------------------------

SERVE_CAPS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
# run A: launch/stats_serve.main's defaults (the reference's documented
# setting); run B: a deployment's scale, StatsConfig() defaults for 1024
# tenants (a 0.54 GB resident bank)
SERVE_RUN_A = dict(tenants=64, k=512, ls=(1.0, 8.0, 64.0), chunk=2048, steps=40,
                   ingest_per_step=16, stream_batch=2048, requests=400, max_batch=256)
SERVE_RUN_B = dict(tenants=1024, k=4096, ls=(1.0, 16.0, 256.0, 4096.0), chunk=2048,
                   steps=64, ingest_per_step=256, stream_batch=2048, requests=2048,
                   max_batch=256)
SERVE_PROFILE_STEPS = 8  # a profiled window after the measured steps
SERVE_CHECKED = 5        # run B: the tenant with the most elements + 4 drawn


def _serve_traffic(run: dict, seed: int, steps: int):
    """The submissions of ``stats_serve.main``'s synthetic workload, drawn in
    its order from ``default_rng(seed)``: per step the ingest slices
    (tenant, Zipf(1.3) keys mod 100,000) and the queries (tenant, cap T,
    segment: all keys or ``HashBucket(8, b)``), Poisson arrivals."""
    import numpy as np
    from repro_torch.core import freqfns
    from repro_torch.core.segments import HashBucket

    rng = np.random.default_rng(seed)
    T, rate = run["tenants"], run["requests"] / run["steps"]
    segments = [None] + [HashBucket(8, b) for b in range(8)]
    arrivals = list(rng.poisson(rate, size=run["steps"]))
    out, n_req = [], 0
    for step in range(steps):
        ingest = [(int(t), (rng.zipf(1.3, size=run["stream_batch"]) % 100_000).astype(np.int64))
                  for t in rng.choice(T, size=min(run["ingest_per_step"], T), replace=False)]
        # the steps past the measured ones (the profiled window) keep the
        # same arrival rate, past the request budget
        n = int(arrivals[step]) if step < run["steps"] else int(rng.poisson(rate))
        queries = []
        for _ in range(n):
            if step < run["steps"] and n_req >= run["requests"]:
                break
            queries.append((int(rng.integers(T)), freqfns.cap(float(rng.choice(SERVE_CAPS))),
                            segments[int(rng.integers(len(segments)))]))
            n_req += 1
        out.append((ingest, queries))
    return out


def _hold_tenants(cfg, tenants, admitted, specs, records, svc) -> tuple[int, int, float]:
    """Each tenant of ``tenants`` against a standalone service fed the same
    admitted slices in the same steps: every query answer (estimate,
    stderr, CI, lane) of the step that completed it, asked as the same
    batch, and at the end every state leaf (tables, taus, summaries,
    positions, remainders), bit for bit.  Returns the answers held, and the
    elements the standalone services observed with the seconds their
    ``observe`` calls took (each between device syncs): the per-tenant
    loop that the bank replaces."""
    import torch
    from repro_torch.stats.query import Query
    from repro_torch.stats.service import StreamStatsService

    by_tenant = {t: [] for t in tenants}
    for step, t, keys in admitted:
        if t in by_tenant:
            by_tenant[t].append((step, keys))
    done = {}
    for rid in sorted(records):
        rec = records[rid]
        if rec.tenant in by_tenant:
            done.setdefault((rec.tenant, rec.done_step), []).append(rid)
    held, loop_elements, loop_s = 0, 0, 0.0

    def observe(lone, keys):
        nonlocal loop_elements, loop_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lone.observe(keys)
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
        loop_elements += len(keys)

    for t in tenants:
        lone = StreamStatsService(cfg)
        slices = by_tenant[t]
        i = 0
        for step in sorted({s for tt, s in done if tt == t}):
            while i < len(slices) and slices[i][0] <= step:
                observe(lone, slices[i][1])
                i += 1
            rids = done[(t, step)]
            got = lone.query_batch([Query(specs[r][1], specs[r][2]) for r in rids])
            for j, r in enumerate(rids):
                rec = records[r]
                want = (float(got.estimates[j]), float(got.stderr[j]), float(got.ci_low[j]),
                        float(got.ci_high[j]), float(got.lanes[j]))
                if (rec.estimate, rec.stderr, rec.ci_low, rec.ci_high, rec.lane) != want:
                    raise AssertionError(f"phase 9: tenant {t} query {r} (step {step}) "
                                         f"{(rec.estimate, rec.stderr, rec.lane)} differs "
                                         f"from its standalone service's {want}")
                held += 1
        for _, keys in slices[i:]:
            observe(lone, keys)
        want = lone._sampler.state_dict()
        got = svc.tenant_state_dict(t)
        for name in want:
            if not (got[name].dtype == want[name].dtype and torch.equal(got[name], want[name])):
                raise AssertionError(f"phase 9: tenant {t} leaf {name} differs from its "
                                     "standalone service's")
    return held, loop_elements, loop_s


def _serve_run(name: str, run: dict, seed: int, ckpt_step: int | None = None) -> dict:
    """One run of the multi-tenant server through ``StatsScheduler.step``:
    the measured steps, then a profiled window, then ``drain``; the launch,
    sync and bit-identity gates (and, with ``ckpt_step``, the checkpoint
    resume and the ``restore_slice`` handoff)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import manager
    from repro_torch.core import incremental
    from repro_torch.kernels.capscore import ops as cops
    from repro_torch.kernels.chunksort import ops as sops
    from repro_torch.stats import query
    from repro_torch.stats.scheduler import ServeConfig, StatsScheduler
    from repro_torch.stats.service import MultiTenantStats, StatsConfig, StreamStatsService

    T, steps = run["tenants"], run["steps"]
    cfg = StatsConfig(k=run["k"], ls=run["ls"], chunk=run["chunk"])
    t0 = time.perf_counter()
    traffic = _serve_traffic(run, seed, steps + SERVE_PROFILE_STEPS)
    t_traffic = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    svc = MultiTenantStats(cfg, n_tenants=T)
    sched = StatsScheduler(svc, ServeConfig(max_ingest_per_step=run["ingest_per_step"],
                                            max_queries_per_step=run["max_batch"]))
    bank = svc._bank
    admitted, specs, records = [], {}, {}
    counts = {"ticks": 0, "stacked_steps": 0, "async_batches": 0, "refreshes": 0,
              "refresh_s": 0.0}
    tick_events = []

    observe = svc.observe

    def logged_observe(tenant, keys, weights=None):
        admitted.append((sched.n_steps, tenant, keys))
        observe(tenant, keys, weights)

    bank_tick = bank.tick

    def checked_tick():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")  # a host sync in a tick fails the run
        try:
            start.record()
            n = bank_tick()
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if n:
            counts["ticks"] += 1
            tick_events.append((start, end, n))
        return n

    update_bank = incremental.update_bank

    def counted_update_bank(*a, **kw):
        counts["stacked_steps"] += 1  # a tick's, or a refresh's padded flush
        return update_bank(*a, **kw)

    refresh = svc.refresh

    def timed_refresh(tenants=None):
        # host time of the snapshot: the drain (the step's tick, when its
        # tenants have full chunks queued), the rows' copy off the card and
        # the engine's build
        t = time.perf_counter()
        engine = refresh(tenants)
        counts["refresh_s"] += time.perf_counter() - t
        counts["refreshes"] += 1
        return engine

    query_batch_async = query.QueryEngine.query_batch_async

    def checked_query_batch_async(engine, queries):
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts["async_batches"] += 1
            return query_batch_async(engine, queries)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    svc.observe = logged_observe
    svc.refresh = timed_refresh
    bank.tick = checked_tick
    incremental.update_bank = counted_update_bank
    query.QueryEngine.query_batch_async = checked_query_batch_async
    ckpt_dir = ROOT / "build" / f"phase9_{name}_ckpt"
    t_ckpt, latencies, prof_out = 0.0, [], {}
    try:
        def serve_step(ingest, queries):
            for t, keys in ingest:
                sched.submit_ingest(t, keys)
            for t, fn, seg in queries:
                specs[sched.submit_query(t, fn, seg)] = (t, fn, seg)
            ids = sched.step()
            for rid in ids:
                records[rid] = sched.pop_result(rid)
            return ids

        sops.sort_with_perm_cuda.launches = 0
        cops.capscore_agg_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(steps):
            for rid in serve_step(*traffic[step]):
                latencies.append(records[rid].latency_s)
            if ckpt_step is not None and step + 1 == ckpt_step:
                tc = time.perf_counter()
                shutil.rmtree(ckpt_dir, ignore_errors=True)
                svc.save_checkpoint(ckpt_dir, ckpt_step)
                t_ckpt = time.perf_counter() - tc
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - t_ckpt
        n_elements, n_queries = sched.n_elements_ingested, sched.n_queries_answered
        refresh_ms = counts["refresh_s"] * 1e3 / steps
        n_refresh = counts["refreshes"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            for step in range(steps, steps + SERVE_PROFILE_STEPS):
                serve_step(*traffic[step])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - tp
        busy_us, launches_n, rows = 0.0, 0, []
        for e in prof.key_averages():
            if "CUDA" in str(getattr(e, "device_type", "")):
                dev_us = getattr(e, "self_device_time_total", None)
                dev_us = dev_us if dev_us is not None else getattr(e, "self_cuda_time_total", 0)
                busy_us += dev_us
                launches_n += e.count
                rows.append({"name": e.key[:100], "launches_per_step": e.count / SERVE_PROFILE_STEPS,
                             "device_ms_per_step": dev_us * 1e-3 / SERVE_PROFILE_STEPS})
        rows.sort(key=lambda r: -r["device_ms_per_step"])
        prof_out = {"steps": SERVE_PROFILE_STEPS, "wall_ms_per_step": prof_wall * 1e3 / SERVE_PROFILE_STEPS,
                    "device_busy_ms_per_step": busy_us * 1e-3 / SERVE_PROFILE_STEPS,
                    "device_busy_share": busy_us * 1e-6 / prof_wall,
                    "kernel_launches_per_step": launches_n / SERVE_PROFILE_STEPS, "top": rows[:8]}
        for rid in sched.drain():
            records[rid] = sched.pop_result(rid)
        torch.cuda.synchronize()
        launches = {"chunksort": sops.sort_with_perm_cuda.launches,
                    "capscore_agg": cops.capscore_agg_cuda.launches}
    finally:
        incremental.update_bank = update_bank
        query.QueryEngine.query_batch_async = query_batch_async
        svc.observe = observe
        svc.refresh = refresh
        bank.tick = bank_tick
    tick_ms = np.array([a.elapsed_time(b) for a, b, _ in tick_events])
    active = np.array([n for _, _, n in tick_events])
    lat_ms = np.sort(np.asarray(latencies)) * 1e3
    out = {"tenants": T, "k": cfg.k, "ls": list(cfg.ls), "chunk": cfg.chunk, "steps": steps,
           "traffic_setup_s": t_traffic, "wall_s": wall, "elements": n_elements,
           "elements_per_s": n_elements / wall, "queries": n_queries,
           "queries_per_s": n_queries / wall,
           "query_p50_ms": float(np.percentile(lat_ms, 50)),
           "query_p99_ms": float(np.percentile(lat_ms, 99)),
           "ticks": counts["ticks"], "stacked_steps": counts["stacked_steps"],
           "mean_active_tenants_per_tick": float(active.mean()),
           "tick_ms_mean": float(tick_ms.mean()), "tick_ms_median": float(np.median(tick_ms)),
           "tick_ms_max": float(tick_ms.max()), "refreshes": n_refresh,
           "refresh_host_ms_per_step": refresh_ms, "launches": launches,
           "launches_per_stacked_step": {k: v / counts["stacked_steps"]
                                         for k, v in launches.items()},
           "async_query_batches": counts["async_batches"], "profile": prof_out,
           "resident_bytes": svc.resident_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "checkpoint_save_s": t_ckpt}
    # one chunksort and one capscore_agg launch per stacked step, for all of
    # its tenants; every tick and every query dispatch ran under
    # sync_debug_mode("error")
    if not counts["ticks"] or any(v != counts["stacked_steps"] for v in launches.values()):
        raise AssertionError(f"phase 9 {name}: launches {launches} for {counts['ticks']} "
                             f"ticks and {counts['stacked_steps']} stacked steps")
    if not counts["async_batches"]:
        raise AssertionError(f"phase 9 {name}: no query batch was dispatched")

    # bit-identity against standalone services
    t0 = time.perf_counter()
    n_el = {}
    for _, t, keys in admitted:
        n_el[t] = n_el.get(t, 0) + len(keys)
    if name == "A":
        checked = list(range(T))
    else:
        top = max(n_el, key=lambda t: (n_el[t], -t))
        rest = [int(t) for t in np.random.default_rng(seed).permutation(T) if t != top]
        checked = [top] + rest[:SERVE_CHECKED - 1]
    out["checked_tenants"] = checked
    out["answers_held"], loop_elements, loop_s = _hold_tenants(cfg, checked, admitted,
                                                               specs, records, svc)
    out["per_tenant_loop_elements_per_s"] = loop_elements / loop_s
    out["standalone_check_s"] = time.perf_counter() - t0

    if ckpt_step is not None:
        t0 = time.perf_counter()
        later = [(s, t, keys) for s, t, keys in admitted if s > ckpt_step]
        resumed = MultiTenantStats(cfg, n_tenants=T)
        if resumed.restore_checkpoint(ckpt_dir) != ckpt_step:
            raise AssertionError("phase 9: restored the wrong step")
        step_of = None
        for s, t, keys in later:
            if step_of is not None and s != step_of:
                resumed.tick()
            resumed.observe(t, keys)
            step_of = s
        got, want = resumed.state_dict(), svc.state_dict()
        for leaf in want:
            if not torch.equal(got[leaf], want[leaf]):
                raise AssertionError(f"phase 9: the resumed bank's {leaf} differs")
        handoff = checked[0]
        lone = StreamStatsService(cfg)
        lone.load_state_dict(manager.restore_slice(ckpt_dir, ckpt_step,
                                                   lone._sampler.state_dict(), handoff))
        for s, t, keys in later:
            if t == handoff:
                lone.observe(keys)
        want_t = svc.tenant_state_dict(handoff)
        for leaf, x in lone._sampler.state_dict().items():
            if not torch.equal(x, want_t[leaf]):
                raise AssertionError(f"phase 9: tenant {handoff} handed off by restore_slice: "
                                     f"{leaf} differs")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        out["checkpoint_check_s"] = time.perf_counter() - t0
        out["handoff_tenant"] = handoff
    return out


def run_multitenant_serving(seed: int) -> dict:
    """Phase 9: runs A and B (module docstring)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": smi}
    for name, run, ckpt in (("A", SERVE_RUN_A, None), ("B", SERVE_RUN_B, 32)):
        t0 = time.perf_counter()
        r = out[name] = _serve_run(name, run, seed, ckpt_step=ckpt)
        r["phase_s"] = time.perf_counter() - t0
        log(f"phase 9 run {name} ({r['tenants']} tenants, k={r['k']}, ls={r['ls']}, "
            f"chunk {r['chunk']}, {r['steps']} steps; card {smi}): {r['elements']} elements "
            f"in {r['wall_s']:.3f} s = {r['elements_per_s']:.6g} elements/s, {r['queries']} "
            f"queries = {r['queries_per_s']:.6g} queries/s, latency p50 "
            f"{r['query_p50_ms']:.3f} ms p99 {r['query_p99_ms']:.3f} ms; {r['ticks']} ticks "
            f"({r['mean_active_tenants_per_tick']:.1f} tenants each), tick {r['tick_ms_mean']:.4f} "
            f"ms mean / {r['tick_ms_median']:.4f} median by CUDA events; {r['refreshes']} "
            f"refreshes, {r['refresh_host_ms_per_step']:.3f} host ms per step (the drain's "
            f"tick included); launches "
            f"{r['launches']} for {r['stacked_steps']} stacked steps; device busy "
            f"{100 * r['profile']['device_busy_share']:.2f}% over {SERVE_PROFILE_STEPS} profiled "
            f"steps ({r['profile']['wall_ms_per_step']:.3f} ms per step, "
            f"{r['profile']['kernel_launches_per_step']:.1f} kernel launches); resident "
            f"{r['resident_bytes']} B, max_memory_allocated {r['max_memory_allocated']} B; "
            f"{len(r['checked_tenants'])} tenants and {r['answers_held']} answers bit-identical "
            f"to standalone services, whose observe calls (the per-tenant loop) ingested "
            f"{r['per_tenant_loop_elements_per_s']:.6g} elements/s; whole run "
            f"{r['phase_s']:.1f} s")
        for row in r["profile"]["top"][:6]:
            log(f"  {row['device_ms_per_step']:9.4f} ms x{row['launches_per_step']:7.1f} per step  "
                f"{row['name']}")
        if "handoff_tenant" in r:
            log(f"phase 9 run {name}: checkpoint at step 32 ({r['checkpoint_save_s']:.2f} s to "
                f"save) restored into a fresh bank, continued: every leaf equal; tenant "
                f"{r['handoff_tenant']} restore_slice'd into a standalone service, continued: equal")
    return out


# ---------------------------------------------------------------------------
# phase 10: the paper's samplers (single sketch, one-shot, two-pass, the
# reference multi-l route, the multi-objective sample)
# ---------------------------------------------------------------------------

SAMPLER_N = 1 << 24         # phase 3's stream
SAMPLER_BATCH = 1 << 20     # observe() batches, as phase 3
SAMPLER_K = 4096
SAMPLER_L = 16.0
SAMPLER_CHUNK = 2048
SAMPLER_PROFILE_STEPS = 8
ORACLE_N = 1 << 18          # the prefix held against the sequential oracles
SAMPLER_KINDS = {"continuous": 16.0, "discrete": 16, "distinct": 1, "sh": 1e9}
FIXED_TAU_CAPACITY = 16384
# Elements per kind of 10b and 10c (each cut is logged on its line).  10a
# is never cut: uncut, with its evict_every=4 sampler, it takes ~115 s or
# more on an H100 by itself, so phase 10 cannot keep to ~120 s.  The cuts
# go in this order: 10c's hash-only kinds, then 10d's length, then 10b's
# hash-only kinds.  A fixed-tau step of a hash-only kind (3.3-5.3 ms) costs
# 1.5-2.5x a continuous one (2.2 ms): its element hashes are int64
# emulation in torch, many launches each, and 10b runs each kind twice (one
# pass per entry point), so those three at the full stream would add
# ~200 s to the script.
FIXED_TAU_N = {"continuous": 1 << 24, "discrete": 1 << 20, "distinct": 1 << 20,
               "sh": 1 << 20}
TWO_PASS_N = {"continuous": 1 << 24, "discrete": 1 << 20, "distinct": 1 << 20,
              "sh": 1 << 20}
MULTI_REF_FULL = 1 << 22    # 10d: the reference route's prefix at full size
MULTI_REF_N = 1 << 20       # ... cut
MULTI_REF_BLOCK = 64        # chunks between lockstep comparisons in 10d
MO_LS = (1.0, 16.0, 256.0, 4096.0)
MAX_ULP = 4


def _stderr(res, fn) -> float:
    """The HT plug-in standard error of ``estimate(res, fn)``, the query
    engine's: sqrt(sum a_x^2 (1 - p_x))."""
    import numpy as np
    from repro_torch.core import estimators

    a = estimators.estimate_per_key(res, fn)
    return float(np.sqrt(np.square(a) @ (1.0 - estimators.inclusion_per_key(res))))


def _same_result(a, b) -> bool:
    import numpy as np

    return (np.array_equal(a.keys, b.keys) and np.array_equal(a.counts, b.counts)
            and np.float32(a.tau) == np.float32(b.tau))


def _exact_counts(keys, ukeys, counts):
    import numpy as np

    return counts[np.searchsorted(ukeys, keys)]


def _sampler_fixed_k(keys, ukeys, counts) -> dict:
    """10a: ``IncrementalSampler(l=16, k=4096)`` over the stream, against
    ``sample_fixed_k``; the estimate; launches; the profile; E = 4."""
    import numpy as np
    from repro_torch.core import estimators, freqfns
    from repro_torch.core import incremental as TI
    from repro_torch.core import vectorized as TV

    n, chunk = len(keys), SAMPLER_CHUNK
    steps = n // chunk
    s = TI.IncrementalSampler(SAMPLER_L, k=SAMPLER_K, chunk=chunk, salt=SALT)

    def ingest():
        for lo in range(0, n, SAMPLER_BATCH):
            s.observe(keys[lo:lo + SAMPLER_BATCH])

    _, t_obs, launches = _counted(ingest, barrier=False)
    if launches["capscore_agg"] != steps:
        raise AssertionError(f"10a: capscore_agg launched {launches['capscore_agg']} times "
                             f"for {steps} chunk steps")
    if launches["chunksort"] < steps:
        raise AssertionError(f"10a: chunksort launched {launches['chunksort']} times for "
                             f"{steps} chunk steps")
    res, t_fin = _synced(s.finalize, barrier=False)
    one, t_one = _synced(lambda: TV.sample_fixed_k(keys, k=SAMPLER_K, l=SAMPLER_L,
                                                   chunk=chunk, salt=SALT), barrier=False)
    if not _same_result(res, one):
        raise AssertionError("10a: IncrementalSampler and sample_fixed_k differ")
    fn = freqfns.cap(SAMPLER_L)
    est, se = estimators.estimate(res, fn), _stderr(res, fn)
    exact = freqfns.exact_statistic(fn, counts)
    z = abs(est - exact) / se
    if not (len(res.keys) == SAMPLER_K and np.isfinite(est) and z <= 5.0):
        raise AssertionError(f"10a: cap_16 estimate {est} is {z:.2f} stderr from exact "
                             f"{exact} ({len(res.keys)} keys)")
    # a warm sampler's chunk steps under the profiler
    warm = iter(range(0, SAMPLER_PROFILE_STEPS * chunk, chunk))
    prof = _device_profile(lambda: s.observe(keys[next(warm):][:chunk]),
                           SAMPLER_PROFILE_STEPS, "capscore_agg_kernel", ("sort_chunk",))
    # evict_every = 4: the lazily evicted table projects to <= k at finalize
    s4 = TI.IncrementalSampler(SAMPLER_L, k=SAMPLER_K, chunk=chunk, salt=SALT, evict_every=4)
    _, t_e4 = _synced(lambda: [s4.observe(keys[lo:lo + SAMPLER_BATCH])
                               for lo in range(0, n, SAMPLER_BATCH)], barrier=False)
    live4 = int((s4.state.table.keys != EMPTY).sum())
    res4 = s4.finalize()
    if len(res4.keys) > SAMPLER_K:
        raise AssertionError(f"10a: the evict_every=4 sampler finalized {len(res4.keys)} keys")
    out = {"elements": n, "chunk_steps": steps, "observe_s": t_obs,
           "elements_per_s": n / t_obs, "chunk_step_ms": t_obs / steps * 1e3,
           "finalize_ms": t_fin * 1e3, "sample_fixed_k_s": t_one,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "cap16_estimate": est, "cap16_exact": exact, "cap16_stderr": se, "abs_z": z,
           "tau": res.tau, "profile": prof, "e4_observe_s": t_e4,
           "e4_live_keys": live4, "e4_final_keys": len(res4.keys)}
    log(f"phase 10a (IncrementalSampler(l={SAMPLER_L:g}, k={SAMPLER_K}) over {n} elements in batches of "
        f"{SAMPLER_BATCH}): {out['elements_per_s']:.4g} elements/s, "
        f"{out['chunk_step_ms']:.4f} ms per chunk step, finalize {out['finalize_ms']:.2f} ms; "
        f"bit-identical to sample_fixed_k ({t_one:.1f} s); launches per step "
        f"{out['launches_per_step']}; cap_16 est {est:.6g} exact {exact:.6g} stderr {se:.4g} "
        f"|z| {z:.2f}; profile over {prof['calls']} steps: {prof['wall_ms_per_call']:.3f} ms "
        f"per step, {prof['kernel_launches_per_call']:.1f} kernel launches, device busy "
        f"{100 * prof['device_busy_share']:.2f}%, capscore_agg {prof['tag_launches_per_call']:g}"
        f" and chunksort {prof['other_launches_per_call']['sort_chunk']:g} per step; "
        f"evict_every=4 over {n} ({t_e4:.1f} s): {live4} live keys, finalize {len(res4.keys)}")
    return out


def _tau_for_size(kind: str, l, counts, size: float) -> float:
    """The threshold whose expected sample size over keys of the exact
    frequencies ``counts`` is ``size`` (bisection in log tau), rounded to
    f32 so the card and the f64 oracles compare against the same value."""
    import math

    import numpy as np
    from repro_torch.core import estimators
    from repro_torch.core.samplers import SampleResult

    def expected(tau):
        return float(np.sum(estimators._inclusion_prob(
            SampleResult(None, None, tau, l, kind), counts)))

    lo, hi = math.log(1e-12), 0.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if expected(math.exp(mid)) < size else (lo, mid)
    return float(np.float32(math.exp(0.5 * (lo + hi))))


def _hold_oracle(tag: str, got, want, continuous: bool) -> float:
    """The reference's tolerances of a chunked sample against its
    sequential oracle (``tests/test_equivalence.py``): keys equal;
    continuous counts within rtol 1e-4 / atol 1e-3, the rest exact.
    Returns the largest count difference."""
    import numpy as np

    if not np.array_equal(got.keys, want.keys):
        raise AssertionError(f"{tag}: {len(np.setxor1d(got.keys, want.keys))} keys differ "
                             f"from the sequential oracle")
    diff = np.abs(got.counts - np.asarray(want.counts, np.float64))
    ok = (np.all(diff <= 1e-3 + 1e-4 * np.abs(want.counts)) if continuous
          else np.array_equal(got.counts, np.asarray(want.counts, np.float64)))
    if not ok:
        raise AssertionError(f"{tag}: counts differ from the oracle's by up to {diff.max()}")
    return float(diff.max()) if len(diff) else 0.0


def _sampler_fixed_tau(keys, ukeys, counts) -> dict:
    """10b: ``sample_fixed_tau`` and ``IncrementalSampler(tau=...)`` for the
    four kinds; a prefix against Algorithms 4 / 2; an overflow raises."""
    import math

    import numpy as np
    from repro_torch.core import incremental as TI
    from repro_torch.core import samplers as TS
    from repro_torch.core import vectorized as TV

    out = {}
    for kind, l in SAMPLER_KINDS.items():
        n = FIXED_TAU_N[kind]
        stream = keys[:n]
        run_counts = counts if n == len(keys) else np.unique(stream, return_counts=True)[1]
        tau = _tau_for_size(kind, l, run_counts, SAMPLER_K)
        one, t_one, launches = _counted(lambda: TV.sample_fixed_tau(
            stream, tau=tau, l=l, kind=kind, chunk=SAMPLER_CHUNK,
            capacity=FIXED_TAU_CAPACITY, salt=SALT), barrier=False)
        s = TI.IncrementalSampler(l, tau=tau, kind=kind, chunk=SAMPLER_CHUNK,
                                  capacity=FIXED_TAU_CAPACITY, salt=SALT)

        def ingest():
            for lo in range(0, n, SAMPLER_BATCH):
                s.observe(stream[lo:lo + SAMPLER_BATCH])

        _, t_inc, _ = _counted(ingest, barrier=False)
        if not _same_result(s.finalize(), one):
            raise AssertionError(f"10b {kind}: IncrementalSampler and sample_fixed_tau differ")
        steps = -(-n // SAMPLER_CHUNK)
        if launches["capscore_agg"] != (steps if kind == "continuous" else 0):
            raise AssertionError(f"10b {kind}: capscore_agg launched {launches['capscore_agg']} "
                                 f"times for {steps} chunk steps")
        head = keys[:ORACLE_N]
        got = TV.sample_fixed_tau(head, tau=tau, l=l, kind=kind, chunk=SAMPLER_CHUNK,
                                  capacity=FIXED_TAU_CAPACITY, salt=SALT)
        if kind == "continuous":
            want = TS.alg4_fixed_tau_continuous(head, None, tau, l=l, salt=SALT)
        else:
            want = TS.alg2_fixed_tau_discrete(head, tau, l=math.inf if kind == "sh" else l,
                                              salt=SALT, kind=kind)
        worst = _hold_oracle(f"10b {kind}", got, want, kind == "continuous")
        out[kind] = {"elements": n, "tau": tau, "sample_size": len(one.keys),
                     "sample_fixed_tau_s": t_one, "incremental_s": t_inc,
                     "chunk_step_ms": t_one / steps * 1e3, "launches": launches,
                     "oracle_elements": len(head), "oracle_keys": len(want.keys),
                     "oracle_worst_count_diff": worst}
        log(f"phase 10b {kind} (l={l:g}, tau={tau:.6g} for an expected {SAMPLER_K} keys, "
            f"{n} elements{'' if n == len(keys) else ', cut from ' + str(len(keys))}): "
            f"{len(one.keys)} keys; sample_fixed_tau {t_one:.2f} s "
            f"({out[kind]['chunk_step_ms']:.4f} ms per chunk step), IncrementalSampler "
            f"{t_inc:.2f} s, bit-identical; launches {launches}; the first {len(head)} "
            f"elements equal {'Algorithm 4' if kind == 'continuous' else 'Algorithm 2'} "
            f"({len(want.keys)} keys, worst count difference {worst:.3g})")
    small = TI.IncrementalSampler(SAMPLER_KINDS["continuous"], tau=out["continuous"]["tau"],
                                  chunk=SAMPLER_CHUNK, capacity=64, salt=SALT)
    small.observe(keys[:ORACLE_N])
    try:
        small.finalize()
    except RuntimeError as e:
        log(f"phase 10b: capacity 64 over {ORACLE_N} elements raises at finalize: {e}")
    else:
        raise AssertionError("10b: a fixed-tau capacity overflow did not raise at finalize")
    return out


def _sampler_two_pass(keys, ukeys, counts) -> dict:
    """10c: ``sample_two_pass(k=4096)`` for the four kinds: exact pass-II
    weights, a prefix against Algorithm 1, ``capscore`` per SCORE_BATCH."""
    import numpy as np
    from repro_torch.core import samplers as TS
    from repro_torch.core import vectorized as TV
    from repro_torch.core.distributed import SCORE_BATCH

    out = {}
    for kind, l in SAMPLER_KINDS.items():
        n = TWO_PASS_N[kind]
        stream = keys[:n]
        res, sec, launches = _counted(lambda: TV.sample_two_pass(
            stream, k=SAMPLER_K, l=l, kind=kind, chunk=SAMPLER_CHUNK, salt=SALT),
            barrier=False)
        want_calls = -(-n // SCORE_BATCH) if kind == "continuous" else 0
        if launches["capscore"] != want_calls:
            raise AssertionError(f"10c {kind}: capscore launched {launches['capscore']} times, "
                                 f"not {want_calls}")
        uk, uc = (ukeys, counts) if n == len(keys) else np.unique(stream, return_counts=True)
        if not (len(res.keys) == SAMPLER_K
                and np.array_equal(res.counts, _exact_counts(res.keys, uk, uc))):
            raise AssertionError(f"10c {kind}: pass-II weights differ from the exact counts")
        head = keys[:ORACLE_N]
        got = TV.sample_two_pass(head, k=SAMPLER_K, l=l, kind=kind, chunk=SAMPLER_CHUNK,
                                 salt=SALT)
        want = TS.alg1_two_pass(head, None, SAMPLER_K, l=l, kind=kind, salt=SALT)
        order = np.argsort(want.keys)
        if not (np.array_equal(got.keys, want.keys[order])
                and np.allclose(got.tau, want.tau, rtol=1e-5, atol=0)
                and np.allclose(got.counts, want.counts[order], rtol=1e-5, atol=0)):
            raise AssertionError(f"10c {kind}: differs from Algorithm 1 on the first "
                                 f"{len(head)} elements (tau {got.tau} vs {want.tau})")
        out[kind] = {"elements": n, "seconds": sec, "elements_per_s": n / sec,
                     "tau": res.tau, "launches": launches,
                     "oracle_elements": len(head), "oracle_tau": want.tau}
        log(f"phase 10c {kind} (l={l:g}, k={SAMPLER_K}, {n} elements"
            f"{'' if n == len(keys) else ', cut from ' + str(len(keys))}): {sec:.2f} s "
            f"({n / sec:.4g} elements/s), tau {res.tau:.6g}; pass-II weights equal the exact "
            f"counts; launches {launches}; the first {len(head)} elements equal Algorithm 1 "
            f"(tau {want.tau:.6g})")
    return out


def _ulp_gap(a, b):
    """Elementwise distance of f32 values in units in the last place."""
    import numpy as np

    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.where(a == b, 0, np.abs(ordered(a) - ordered(b)))


def _lockstep_flags(f, r):
    """Per lane, on the device with one copy back: do the fused state ``f``
    and the reference-route state ``r`` hold the same keys, and within the
    capscore_agg contract the rest?  (key sets; kb, seed and step exact;
    counts within rtol 1e-5 plus 4 ulp of a unit weight; tau within rtol
    1e-5), and are their summaries (keys and seeds) equal?  The reference
    route leaves its evicted slots EMPTY in place: its rows are sorted by
    key first."""
    import torch

    rtol, atol = 1e-5, MAX_ULP * 2.0**-23
    o = torch.sort(r.table.keys, dim=-1, stable=True).indices
    rk, rc, rkb, rsd = (x.gather(-1, o) for x in r.table[:4])
    fk, fc, fkb, fsd = f.table[:4]
    keys = (fk == rk).all(-1)
    rest = (((fkb == rkb) & (fsd == rsd)).all(-1)
            & ((fc - rc).abs() <= atol + rtol * rc.abs()).all(-1)
            & (f.table.step == r.table.step)
            & ((f.table.tau == r.table.tau)
               | ((f.table.tau - r.table.tau).abs() <= rtol * r.table.tau.abs())))
    bk = (f.bk_keys == r.bk_keys).all(-1) & (f.bk_seeds == r.bk_seeds).all(-1)
    return torch.stack([keys, rest, bk]).cpu().numpy()


def _explain_split(before, after_f, after_r, ck, cw, spec, lanes) -> list:
    """One record ``(gap_ulp, lane, key, pair)`` per key on which the two
    routes' tables differ after one chunk step, in ``lanes``: the key's
    eviction race z in the fused route's merged table against the nearest z
    on the other side of the cut (inf where the key is not in that table:
    an entry difference, which no float pair explains here, since both
    routes compute Delta alike)."""
    import numpy as np
    from repro_torch.core import vectorized as TV
    from repro_torch.core.segments import chunk_order
    from repro_torch.kernels.capscore.ops import capscore_agg

    st = before
    order = chunk_order(ck, spec.eids(st.n_seen, ck.device), cw)
    w_total, entered, contrib, kb_min, min_score = capscore_agg(
        order.ks, order.eids, order.ws, order.seg, st.l, st.table.tau, st.salt)
    merged = TV.fixed_k_merge(st.table, TV.ChunkAgg(order.ukeys, w_total, entered, contrib,
                                                    kb_min, min_score))
    valid, z, *_ = TV._evict_z(merged.keys, merged.counts, merged.kb, merged.tau, st.l,
                               st.salt, merged.step)
    mkeys, z, valid = merged.keys.cpu().numpy(), z.cpu().numpy(), valid.cpu().numpy()
    fk, rk = after_f.table.keys.cpu().numpy(), after_r.table.keys.cpu().numpy()
    records = []
    for j in sorted(lanes):
        kept = fk[j][fk[j] != EMPTY]
        side = np.isin(mkeys[j], kept) & valid[j]
        for x in set(kept.tolist()) ^ set(rk[j][rk[j] != EMPTY].tolist()):
            at = np.nonzero((mkeys[j] == x) & valid[j])[0]
            if not len(at):
                records.append((np.inf, j, x, "not in the merged table (entry)"))
                continue
            other = valid[j] & (side != side[at[0]])
            gaps = _ulp_gap(np.broadcast_to(z[j, at[0]], z[j][other].shape), z[j][other])
            m = int(np.argmin(gaps)) if gaps.size else None
            records.append((float(gaps[m]) if gaps.size else np.inf, j, x,
                            f"z={z[j, at[0]]!r} vs z={z[j][other][m] if gaps.size else None!r}"
                            " across tau*"))
    return sorted(records, key=lambda r: -r[0])


def _sampler_multi_reference(keys) -> dict:
    """10d: ``StatsConfig()``'s grid through ``update_multi(reference=True)``
    and the fused ``update_multi``, chunk by chunk in lockstep."""
    import numpy as np
    import torch
    from repro_torch.core import incremental as TI

    chunk, n = SAMPLER_CHUNK, MULTI_REF_N
    stF, spec = TI.init_multi_state(MO_LS, k=SAMPLER_K, chunk=chunk, salt=SALT)
    stR, _ = TI.init_multi_state(MO_LS, k=SAMPLER_K, chunk=chunk, salt=SALT)
    dev = stF.l.device
    kd = torch.from_numpy(keys[:n].astype(np.int32)).to(dev)
    wd = torch.ones(n, device=dev)
    lanes, diverged = set(range(len(MO_LS))), {}
    t_f = t_r = 0.0
    launches = dict.fromkeys(_counters(), 0)
    worst_gap = 0.0
    for c in range(n // chunk):
        ck, cw = kd[c * chunk:(c + 1) * chunk], wd[c * chunk:(c + 1) * chunk]
        f1, sec, _ = _counted(lambda: TI.update_multi(stF, ck, cw, spec), barrier=False)
        t_f += sec
        r1, sec, la = _counted(lambda: TI.update_multi(stR, ck, cw, spec, reference=True),
                               barrier=False)
        t_r += sec
        launches = {k: launches[k] + la[k] for k in launches}
        keys_eq, rest_ok, bk_eq = _lockstep_flags(f1, r1)
        if not bk_eq.all():
            raise AssertionError(f"10d chunk {c}: summaries differ in lanes "
                                 f"{np.nonzero(~bk_eq)[0].tolist()}")
        split = {j for j in lanes if not keys_eq[j]}
        bad = [j for j in lanes - split if not rest_ok[j]]
        if bad:
            raise AssertionError(f"10d chunk {c}: lanes {bad} hold the same keys but differ "
                                 "beyond the capscore_agg contract")
        if split:
            records = _explain_split(stF, f1, r1, ck, cw, spec, split)
            gap, j, x, pair = records[0]
            if gap > MAX_ULP:
                raise AssertionError(f"10d chunk {c}: lane {j} key {x} diverged unexplained; "
                                     f"nearest deciding pair {pair}, {gap} ulp")
            worst_gap = max(worst_gap, gap)
            lanes -= split
            diverged.update({j: c for j in split})
            log(f"phase 10d: lanes {sorted(split)} diverged at chunk {c}, each differing key "
                f"explained by a deciding pair within {gap:g} ulp ({pair}); dropped")
        stF, stR = f1, r1
    steps = n // chunk
    if launches["capscore_multi"] != steps:
        raise AssertionError(f"10d: capscore_multi launched {launches['capscore_multi']} "
                             f"times for {steps} chunk steps")
    if not lanes:
        raise AssertionError("10d: every lane diverged")
    rf = TI.finalize_multi(stF, spec, ls=MO_LS)
    rr = TI.finalize_multi(stR, spec, ls=MO_LS)
    for j in sorted(lanes):
        a, b = rf[MO_LS[j]], rr[MO_LS[j]]
        if not (np.array_equal(a.keys, b.keys)
                and np.allclose(a.counts, b.counts, rtol=1e-5, atol=MAX_ULP * 2.0**-23)
                and np.allclose(a.tau, b.tau, rtol=1e-5, atol=0)):
            raise AssertionError(f"10d: lane l={MO_LS[j]} finalizes apart")
    out = {"elements": n, "chunk_steps": steps, "fused_chunk_step_ms": t_f / steps * 1e3,
           "reference_chunk_step_ms": t_r / steps * 1e3, "reference_launches": launches,
           "diverged_lanes": {str(MO_LS[j]): c for j, c in diverged.items()},
           "worst_explained_gap_ulp": worst_gap}
    log(f"phase 10d (ls={MO_LS}, k={SAMPLER_K}, {n} elements{'' if n == MULTI_REF_FULL else ', cut from ' + str(MULTI_REF_FULL)}, "
        f"one chunk per call, synced): fused {out['fused_chunk_step_ms']:.4f} ms per chunk "
        f"step, reference route {out['reference_chunk_step_ms']:.4f} ms; {launches['capscore_multi']}"
        f" capscore_multi launches for {steps} steps; lanes in lockstep to the end "
        f"{[MO_LS[j] for j in sorted(lanes)]} (keys, kb, seeds, steps, summaries exact; counts, "
        f"tau within rtol 1e-5), diverged {out['diverged_lanes']}")
    return out


def _sampler_multiobjective(keys, ukeys, counts) -> dict:
    """10e: ``multiobjective_sample(k=4096, ls=(1, 16, 256, 4096))``: the
    card's ``per_key_randomness`` against its numpy plain version, |S_L|
    against k ln n, the §6.2 estimates of cap_T."""
    import math

    import numpy as np
    from repro_torch.core import freqfns
    from repro_torch.core import multiobjective as TM

    n = len(keys)
    (uk, hx, y, wx), t_dev = _synced(lambda: TM.per_key_randomness(keys, None, SALT),
                                     barrier=False)
    t0 = time.perf_counter()
    p_uk, p_hx, p_y, p_wx = TM.per_key_randomness_np(keys, None, SALT)
    t_np = time.perf_counter() - t0
    if not (np.array_equal(uk, p_uk) and np.array_equal(hx, p_hx)):
        raise AssertionError("10e: per_key_randomness keys or hx differ from the plain version")
    ulps = [float(np.max(np.abs(a - b) / np.spacing(np.abs(b)))) for a, b in ((y, p_y), (wx, p_wx))]
    if max(ulps) > 2:
        raise AssertionError(f"10e: per_key_randomness y / wx differ by {ulps} f64 ulp")
    (union, w_u, taus, per_l), t_mo = _synced(
        lambda: TM.multiobjective_sample(keys, None, SAMPLER_K, MO_LS, salt=SALT), barrier=False)
    all_l = TM.union_sample_all_l(uk, hx, y, SAMPLER_K)
    bound = SAMPLER_K * math.log(n)
    rel = {}
    for T in MO_LS:
        est = TM.estimate_multi(freqfns.cap(T), union, w_u, taus)
        exact = freqfns.exact_statistic(freqfns.cap(T), counts)
        rel[str(T)] = (est - exact) / exact
    if not all(np.isfinite(v) for v in rel.values()):
        raise AssertionError(f"10e: non-finite estimates {rel}")
    out = {"elements": n, "distinct_keys": len(uk), "per_key_randomness_s": t_dev,
           "plain_s": t_np, "y_wx_max_ulp": ulps, "multiobjective_sample_s": t_mo,
           "grid_union_size": len(union), "all_l_union_size": len(all_l),
           "k_ln_n": bound, "rel_err_cap": rel}
    log(f"phase 10e (multiobjective_sample, k={SAMPLER_K}, ls={MO_LS}, {n} elements, "
        f"{len(uk)} keys): per_key_randomness on the card {t_dev:.3f} s (numpy {t_np:.2f} s), "
        f"keys and hx exact, y / wx within {ulps} ulp; whole sample {t_mo:.2f} s; "
        f"|S_grid| {len(union)}, |S_L| over all l {len(all_l)} against k ln n = {bound:.0f} "
        f"(Lemma 6.1); estimate_multi relative error of cap_T {rel}")
    return out


def run_samplers(seed: int) -> dict:
    """Phase 10 over phase 3's stream: 10a-10e, each kernel's launches on
    these paths, and the seconds of each part."""
    import numpy as np
    from repro_torch.data.streams import zipf_keys

    keys = zipf_keys(np.random.default_rng(seed), SAMPLER_N, 1.2, 1 << 22)
    ukeys, counts = np.unique(keys, return_counts=True)
    out, seconds = {}, {}
    for name, fn, args in (("10a", _sampler_fixed_k, (keys, ukeys, counts)),
                           ("10b", _sampler_fixed_tau, (keys, ukeys, counts)),
                           ("10c", _sampler_two_pass, (keys, ukeys, counts)),
                           ("10d", _sampler_multi_reference, (keys,)),
                           ("10e", _sampler_multiobjective, (keys, ukeys, counts))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    paths = {"10a": out["10a"]["launches"],
             "10b": {k: sum(r["launches"][k] for r in out["10b"].values()) for k in _counters()},
             "10c": {k: sum(r["launches"][k] for r in out["10c"].values()) for k in _counters()},
             "10d": out["10d"]["reference_launches"]}
    out["launches"] = {k: {p: paths[p][k] for p in paths} for k in _counters()}
    out["seconds"] = seconds
    log("phase 10 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; launches on its paths {out['launches']}")
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
    exact_f32()
    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    kernels = [timed("2 chunksort", check_chunksort, device, rng)]
    kernels[0].update(timed("2 chunksort rows", check_chunksort_rows, device, rng))
    device_us = {}
    for check in (check_capscore_agg, check_capscore_multi, check_capscore):
        entry, device_us[entry["name"]] = timed(f"2 {check.__name__[6:]}", check, device, rng)
        kernels.append(entry)
    kernels[1].update(timed("2 capscore_agg batch", check_capscore_agg_batch, device, rng))
    flash, flash_prefill = timed("2c", check_flash_attention, device, args.seed)
    kernels.extend(flash)
    segsum, segsum_serving = timed("2d segment_sum", check_segment_sum, device, rng)
    kernels.append(segsum)
    bag, bag_serving = timed("2d embedding_bag", check_embedding_bag, device, rng)
    kernels.append(bag)

    main_path = timed("3", run_main_path, args.seed, 1 << 24, 1 << 20)
    timed("4", run_state_round_trip, args.seed, 1 << 22)

    profile = timed("5", run_profile, args.seed, PROFILE_STEPS)
    distributed = timed("6", run_distributed, args.seed, 1 << 24, 1 << 20)
    lm = timed("7", run_lm_serving, args.seed, device)
    recsys = timed("8", run_recsys_serving, args.seed, device)
    serving = timed("9", run_multitenant_serving, args.seed)
    samplers = timed("10", run_samplers, args.seed)
    log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    # segment_sum is on no path: the two-tower pooling, its one user, runs
    # the gather-fused embedding_bag kernel, and phase 8 checks that it
    # launches segment_sum no time.  Phase 2d drives it alone, so its path
    # count is 0 and the gate below passes it by name.
    launches = {**main_path["launches"], **distributed["launches"],
                "flash_attention": lm["launches"]["flash_attention_tc"],
                "flash_attention_f32": lm["launches_f32_prefill"]["flash_attention_tf32"],
                **recsys["launches"],
                "segment_sum": 0}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    # phase 9's own path: the bank's launches per stacked step (a tick, or a
    # refresh's padded flush), the same for both runs
    for k in kernels[:2]:
        k["bank_launches_per_tick"] = serving["B"]["launches_per_stacked_step"][k["name"]]
        k["launches_phase9"] = {run: serving[run]["launches"][k["name"]] for run in ("A", "B")}
    # phase 10's paths: each kernel's launches in 10a-10d (0 where a path
    # does not run it)
    for k in kernels:
        k["launches_phase10"] = samplers["launches"].get(
            k["name"], dict.fromkeys(("10a", "10b", "10c", "10d"), 0))
    idle = [k["name"] for k in kernels if not k["launches"] and k["name"] != "segment_sum"]
    idle += [f"{name} in {part}" for name, part in (("chunksort", "10a"), ("capscore_agg", "10a"),
                                                   ("capscore", "10c"), ("capscore_multi", "10d"))
             if not samplers["launches"][name][part]]
    if idle:
        raise AssertionError(f"kernels launched no time on their paths: {idle}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "seed": args.seed, "kernels": kernels,
         "device_us_per_launch_phase2": device_us,
         "flash_attention_prefill_shape": flash_prefill,
         "segment_sum_serving_shapes": segsum_serving,
         "embedding_bag_serving_shapes": bag_serving, "main_path": main_path,
         "distributed": distributed, "lm_serving": lm, "recsys_serving": recsys,
         "multitenant_serving": serving, "samplers": samplers,
         "seconds": time.perf_counter() - t_start, "phase_seconds": phase_s},
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
