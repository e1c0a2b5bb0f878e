#!/usr/bin/env python3
"""Build variants of the ``embedding_bag``, ``chunksort``, ``capscore_agg`` and
``capscore_multi`` kernels and time each at the main path's shapes: what each
design choice is worth on the card.

    python3 kernel_variants.py [--seed 0]

Each variant is compiled into a temporary directory (the checkout's sources
are not touched) and swapped in for the port's library, so it runs through
the port's own wrapper:

* ``embedding_bag`` — ``src/repro_torch/kernels/csrc/embedding_bag.cu`` with
  1 row in flight per warp (the source as it is), or with its row loop
  replaced by one that loads 2, 4, 8 or 16 rows before it adds any of them
  (``rows2`` .. ``rows16``), and ``rows1_vec4`` (f32 rows read by two warps of 128 columns each,
  not one of 256), each on two-tower serving's history pooling, Zipf(1.2) ids
  over a 10,000,000-row table of 256 f32 (the serving table), 10% padding,
  bags of 50: serve_p99 (512 bags) and serve_bulk (262,144 bags);
* ``chunksort`` — one 2048-key Zipf(1.2) ingest chunk sorted by
  ``registers`` (``chunksort.cu`` as it is: the bitonic network in
  registers, each compare-exchange one predicated swap),
  ``registers_select`` (the same network taking min and max by selects,
  then ordering them), ``smem_bitonic`` (the same source with chunks taking the
  shared-memory network of larger inputs, the kernel of earlier versions),
  ``radix4`` and ``radix6`` (a block-wide stable LSD radix sort of the int32
  keys with their indices, CUB's ``BlockRadixSort`` with 4- and 6-bit
  digits: 8 and 6 passes; 8-bit digits need more than the 48 KB of static
  shared memory at 256 threads), beside ``torch.sort(stable=True)``.

* ``capscore_agg`` — ``scan`` (``capscore_agg.cu`` as it is: one CTA of
  512 threads x 4 elements per chunk, segmented scans, rows staged in shared
  memory, helper CTAs for the identity rows), ``scan_256x8`` (256 threads x
  8 elements), ``rows_unstaged`` (segment ends store their rows straight to
  global memory), ``tail_in_cta0`` (no helper CTAs: CTA 0 writes the rows
  past the last segment) and ``warp_per_key`` (the kernel it replaced: one
  warp per output row, binary searches for the segment, two walks over it),
  on one 2048-element Zipf(1.2) ingest chunk and on a chunk of one key, L =
  4, with finite and infinite taus;
* ``capscore_multi`` — ``vec4`` (``capscore.cu`` as it is: four elements per
  thread, 16-byte loads and stores, at most 8 blocks per SM) and
  ``per_element`` (the kernel it replaced: one thread per element, scalar
  I/O), at distributed pass I's launch of 2^20 elements and at one
  2048-element chunk, L = 4.

Every variant is held against the plain version first (``embedding_bag_ref``
within rtol 1e-5 / atol 1e-5 max|want|; ``chunksort`` bit-identical;
``capscore_agg`` entered/kb_min/min_score bit-identical, sums within rtol
1e-5; ``capscore_multi`` bit-identical, NaN at NaN).  Times:
CUDA events per call over back-to-back calls, the variants in turns, twice;
and each kernel's own device time per launch in ``torch.profiler`` (for
``torch.sort``, the device time of all the kernels one call launches).
Needs one card; writes ``chiprun_out/kernel_variants.json`` and prints one
JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BAG_ROWS = {"rows1": 1, "rows2": 2, "rows4": 4, "rows8": 8, "rows16": 16}
BAG_TABLE_ROWS = 10_000_000
BAG_SHAPES = {"serve_p99": 512, "serve_bulk": 262_144}
BAG_LEN = 50
RADIX = """#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 256, ITEMS = 8, N = THREADS * ITEMS;

__global__ void __launch_bounds__(THREADS)
radix_chunk(const int* __restrict__ keys, int n, int* ks_out, long long* perm_out) {
  using Sort = cub::BlockRadixSort<int, THREADS, ITEMS, int, DIGIT_BITS>;
  __shared__ typename Sort::TempStorage tmp;
  int k[ITEMS], v[ITEMS];
  const int first = threadIdx.x * ITEMS;
  for (int r = 0; r < ITEMS; ++r) {
    const int i = first + r;
    k[r] = i < n ? keys[i] : 0x7fffffff;  // pads after real EMPTY keys: stable
    v[r] = i;
  }
  Sort(tmp).Sort(k, v);
  for (int r = 0; r < ITEMS; ++r) {
    if (first + r < n) { ks_out[first + r] = k[r]; perm_out[first + r] = v[r]; }
  }
}
}  // namespace

extern "C" int chunksort_block() { return N; }

extern "C" int chunksort_sort_pairs(const int* keys, int n, int* ks_out, long long* perm_out,
                                    int*, int*, void* stream) {
  if (n <= 0) return 0;
  if (n > N) return int(cudaErrorInvalidValue);
  radix_chunk<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(keys, n, ks_out, perm_out);
  return int(cudaGetLastError());
}
"""
# embedding_bag.cu's row loop, one row at a time, and the loop of the
# variants that hold ROWS rows in flight per warp
ONE_ROW = """    while (live) {  // warp-uniform
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const long long r = __shfl_sync(FULL, row, src);
      const float wr = __shfl_sync(FULL, w, src);
      if (active) {
        float v[VEC];
        load_row<T, VEC>(table + r * row_stride + col, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float x = v[k];
          if (wkind == 1) x = x * wr;
          else if (wkind == 2) x = round_to<T>(x * wr);
          acc[k] += double(x);  // ascending row order
        }
      }
    }"""
ROWS_LOOP = """    while (live) {  // warp-uniform
      constexpr int ROWS = %d;
      int src[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        src[u] = live ? __ffs(live) - 1 : -1;
        live &= live - 1;
      }
      float v[ROWS][VEC];
      float wu[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (src[u] >= 0) {
          const long long r = __shfl_sync(FULL, row, src[u]);
          wu[u] = __shfl_sync(FULL, w, src[u]);
          if (active) load_row<T, VEC>(table + r * row_stride + col, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (src[u] >= 0 && active) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            float x = v[u][k];
            if (wkind == 1) x = x * wu[u];
            else if (wkind == 2) x = round_to<T>(x * wu[u]);
            acc[k] += double(x);  // ascending row order
          }
        }
      }
    }"""
# variant -> (source to copy, [(text of it, the text that replaces it)]) or
# (None, full text)
VARIANTS = {
    **{name: ("embedding_bag", [] if r == 1 else  # 1: the source as it is
              [(ONE_ROW, ROWS_LOOP % r)])
       for name, r in BAG_ROWS.items()},
    "rows1_vec4": ("embedding_bag", [("dispatch<float, 8, I>", "dispatch<float, 4, I>")]),
    "registers": ("chunksort", []),
    "registers_select": ("chunksort", [
        ("""  if ((a > b) == ascending) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }""", """  const unsigned long long lo = a < b ? a : b;
  const unsigned long long hi = a < b ? b : a;
  a = ascending ? lo : hi;
  b = ascending ? hi : lo;"""),
        ("x[r] = (x[r] < y) == take_lo ? x[r] : y;",
         "x[r] = take_lo ? (x[r] < y ? x[r] : y) : (x[r] < y ? y : x[r]);")]),
    "smem_bitonic": ("chunksort", [("  if (n <= CHUNK) {", "  if (n <= 0) {")]),
    "radix4": (None, "#define DIGIT_BITS 4\n" + RADIX),
    "radix6": (None, "#define DIGIT_BITS 6\n" + RADIX),
}
# capscore_agg.cu's segment ends storing their rows to global memory
ROWS_TO_GLOBAL = """{
          const int r = s[k];
          if (g == 0) o.w_total[r] = run.w;
          for (int j = 0; j < G && j0 + j < L; ++j) {
            const size_t x = static_cast<size_t>(j0 + j) * C + r;
            o.entered[x] = (run.flags >> j) & 1u;
            o.contrib[x] = run.c[j];
            o.kb_min[x] = kb[j];
            o.min_score[x] = run.m[j];
          }
        }"""
# the capscore kernels before their redesign, whole (comments dropped)
WARP_PER_KEY_AGG = """#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash32.cuh"

namespace {

using hash32::hash3;
using hash32::u01;
using hash32::SALT_ELEM;
using hash32::SALT_KEYBASE;

constexpr int EMPTY_KEY = 2147483647;
constexpr int NO_ENTRY = 2147483647;  // > any element index
constexpr int GROUP = 8;  // lanes scored per walk (register arrays)
constexpr int THREADS = 256;

__device__ __forceinline__ int lower_bound(const int* seg, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
capscore_agg_kernel(const int* __restrict__ ks, const int* __restrict__ eids,
                    const float* __restrict__ ws, const int* __restrict__ seg,
                    int C, const float* __restrict__ ls,
                    const float* __restrict__ taus, int L, uint32_t salt,
                    float* __restrict__ w_total, uint8_t* __restrict__ entered,
                    float* __restrict__ contrib, float* __restrict__ kb_min,
                    float* __restrict__ min_score) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= C) return;  // whole warps: blockDim is a multiple of 32
  const int lo = lower_bound(seg, C, row);
  const int hi = lower_bound(seg, C, row + 1);
  if (lo == hi || ks[lo] == EMPTY_KEY) {
    if (lane == 0) {
      w_total[row] = 0.0f;
      for (int j = 0; j < L; ++j) {
        entered[j * C + row] = 0;
        contrib[j * C + row] = 0.0f;
        kb_min[j * C + row] = INFINITY;
        min_score[j * C + row] = INFINITY;
      }
    }
    return;
  }
  const float ku = u01(hash3(static_cast<uint32_t>(ks[lo]), SALT_KEYBASE, salt));
  float wt = 0.0f;
  for (int j0 = 0; j0 < L; j0 += GROUP) {
    float lv[GROUP], tau[GROUP], inv_l[GROUP], kb[GROUP], ms[GROUP];
    float fe_val[GROUP], after[GROUP];
    int fe[GROUP];
    bool gate_all[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const bool on = j0 + j < L;
      lv[j] = on ? ls[j0 + j] : 1.0f;
      tau[j] = on ? taus[j0 + j] : 0.0f;
      inv_l[j] = 1.0f / lv[j];
      kb[j] = ku / lv[j];  // division, as the plain version: not ku * inv_l
      gate_all[j] = tau[j] * lv[j] > 1.0f || kb[j] < tau[j];
      ms[j] = INFINITY;
      fe[j] = NO_ENTRY;
      fe_val[j] = 0.0f;
      after[j] = 0.0f;
    }
    for (int i = lo + lane; i < hi; i += 32) {
      const float w = ws[i];
      const float u = u01(hash3(static_cast<uint32_t>(eids[i]), SALT_ELEM, salt));
      const float e = -log1pf(-u);
      const float v = e / w;
      if (j0 == 0) wt += w;
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j0 + j < L) {
          const float score = v <= inv_l[j] ? kb[j] : v;
          const float delta = e / fmaxf(inv_l[j], tau[j]);
          ms[j] = fminf(ms[j], score);
          if (fe[j] == NO_ENTRY && delta < w && gate_all[j]) {
            fe[j] = i;
            fe_val[j] = w - delta;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      for (int off = 16; off > 0; off >>= 1) {
        const int oi = __shfl_xor_sync(0xffffffffu, fe[j], off);
        const float ov = __shfl_xor_sync(0xffffffffu, fe_val[j], off);
        if (oi < fe[j]) { fe[j] = oi; fe_val[j] = ov; }
        ms[j] = fminf(ms[j], __shfl_xor_sync(0xffffffffu, ms[j], off));
      }
    }
    for (int i = lo + lane; i < hi; i += 32) {
      const float w = ws[i];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (i > fe[j]) after[j] += w;
      }
    }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      for (int off = 16; off > 0; off >>= 1) {
        after[j] += __shfl_xor_sync(0xffffffffu, after[j], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j0 + j < L) {
          const int o = (j0 + j) * C + row;
          const bool ent = fe[j] != NO_ENTRY;
          entered[o] = ent ? 1 : 0;
          contrib[o] = ent ? fe_val[j] + after[j] : 0.0f;
          kb_min[o] = kb[j];
          min_score[o] = ms[j];
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    wt += __shfl_xor_sync(0xffffffffu, wt, off);
  }
  if (lane == 0) w_total[row] = wt;
}

}  // namespace

extern "C" int capscore_agg_launch(const int* ks, const int* eids,
                                   const float* ws, const int* seg, int C,
                                   const float* ls, const float* taus, int L,
                                   unsigned int salt, float* w_total,
                                   unsigned char* entered, float* contrib,
                                   float* kb_min, float* min_score,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int warps_per_block = THREADS / 32;
  const int blocks = (C + warps_per_block - 1) / warps_per_block;
  capscore_agg_kernel<<<blocks, THREADS, 0, stream>>>(
      ks, eids, ws, seg, C, ls, taus, L, salt, w_total, entered, contrib,
      kb_min, min_score);
  return static_cast<int>(cudaGetLastError());
}
"""
PER_ELEMENT_SCORE = """#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash32.cuh"

namespace {

using hash32::hash3;
using hash32::u01;
using hash32::SALT_ELEM;
using hash32::SALT_KEYBASE;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // grid-stride beyond 16 blocks per SM

struct Element {
  float w, e, v, ku;
};

__device__ __forceinline__ Element element(const int* keys, const int* eids,
                                           const float* weights, int i,
                                           uint32_t salt) {
  Element x;
  x.w = weights[i];
  const float u = u01(hash3(static_cast<uint32_t>(eids[i]), SALT_ELEM, salt));
  x.e = -log1pf(-u);
  x.v = x.e / x.w;
  x.ku = u01(hash3(static_cast<uint32_t>(keys[i]), SALT_KEYBASE, salt));
  return x;
}

__device__ __forceinline__ void score_lane(const Element& x, float l, float tau,
                                           float* score, float* delta,
                                           int* entry, float* kb) {
  const float inv_l = 1.0f / l;
  const float k = x.ku / l;  // division, as the plain version: not ku * inv_l
  *score = x.v <= inv_l ? k : x.v;
  const float d = x.e / fmaxf(inv_l, tau);
  *delta = d;
  *entry = (d < x.w && (tau * l > 1.0f || k < tau)) ? 1 : 0;
  *kb = k;
}

__global__ void __launch_bounds__(THREADS)
capscore_multi_kernel(const int* __restrict__ keys, const int* __restrict__ eids,
                      const float* __restrict__ weights, int n,
                      const float* __restrict__ ls,
                      const float* __restrict__ taus, int L, uint32_t salt,
                      float* __restrict__ score, float* __restrict__ delta,
                      int* __restrict__ entry, float* __restrict__ kb) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const Element x = element(keys, eids, weights, i, salt);
    for (int j = 0; j < L; ++j) {
      const size_t o = static_cast<size_t>(j) * n + i;
      score_lane(x, ls[j], taus[j], score + o, delta + o, entry + o, kb + o);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
capscore_kernel(const int* __restrict__ keys, const int* __restrict__ eids,
                const float* __restrict__ weights, int n, float l, float tau,
                uint32_t salt, float* __restrict__ score,
                float* __restrict__ delta, int* __restrict__ entry) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const Element x = element(keys, eids, weights, i, salt);
    float k;
    score_lane(x, l, tau, score + i, delta + i, entry + i, &k);
  }
}

int blocks_for(int n) {
  const int b = (n + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

extern "C" int capscore_multi_launch(const int* keys, const int* eids,
                                     const float* weights, int n,
                                     const float* ls, const float* taus, int L,
                                     unsigned int salt, float* score,
                                     float* delta, int* entry, float* kb,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  capscore_multi_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      keys, eids, weights, n, ls, taus, L, salt, score, delta, entry, kb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capscore_launch(const int* keys, const int* eids,
                               const float* weights, int n, float l, float tau,
                               unsigned int salt, float* score, float* delta,
                               int* entry, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  capscore_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      keys, eids, weights, n, l, tau, salt, score, delta, entry);
  return static_cast<int>(cudaGetLastError());
}
"""
VARIANTS.update({
    "scan": ("capscore_agg", []),
    "scan_256x8": ("capscore_agg", [("constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
                                    ("constexpr int ITEMS = 4; ", "constexpr int ITEMS = 8; ")]),
    # segment ends store their rows straight to global memory, unstaged
    "rows_unstaged": ("capscore_agg", [("stage_row(st, s[k], A, g, run, kb);", ROWS_TO_GLOBAL),
                                       ("const int rows = min(min(B, C) - A, TILE);",
                                        "const int rows = 0;")]),
    # CTA 0 writes the identity rows past the last segment itself
    "tail_in_cta0": ("capscore_agg", [
        ("const int helpers = tail_ctas < MAX_HELPERS ? tail_ctas : MAX_HELPERS;",
         "const int helpers = 0;"),
        ("  for (int g = t; g < groups; g += THREADS) carry[g] = identity();\n",
         "  for (int r = max(seg[C - 1] + 1, 0) + t; r < C; r += THREADS) identity_row(o, r);\n"
         "  for (int g = t; g < groups; g += THREADS) carry[g] = identity();\n")]),
    "warp_per_key": (None, WARP_PER_KEY_AGG),
    "vec4": ("capscore", []),
    "per_element": (None, PER_ELEMENT_SCORE),
})
SORTS = ("registers", "registers_select", "smem_bitonic", "radix4", "radix6")
AGGS = ("scan", "scan_256x8", "rows_unstaged", "tail_in_cta0", "warp_per_key")
SCORES = ("vec4", "per_element")
BAGS = (*BAG_ROWS, "rows1_vec4")
PARTS = {"capscore": AGGS + SCORES, "embedding_bag": BAGS, "chunksort": SORTS}


def build(out_dir: Path, names) -> dict[str, Path]:
    """One nvcc per variant named, all at once; returns name -> library."""
    from repro_torch.kernels import _build

    jobs = {}
    for name in names:
        source, edits = VARIANTS[name]
        if source is None:
            text = edits
        else:
            text = (_build.CSRC / f"{source}.cu").read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: the text to replace is not in {source}.cu once")
                text = text.replace(old, new)
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                        "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        built[name] = lib
    return built


def use_library(name: str, signatures: dict, path: Path) -> None:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    _build._LIBS[name] = lib


def use_bag_library(path: Path) -> None:
    from repro_torch.kernels.embedding_bag import ops

    use_library("embedding_bag", ops._BAG_SIGNATURES, path)


def use_sort_library(path: Path) -> None:
    from repro_torch.kernels.chunksort import ops

    use_library("chunksort", ops._SIGNATURES, path)
    ops._library.cache_clear()


def time_capscore(cs, rng, device, built) -> dict:
    """The capscore_agg and capscore_multi variants in turns, twice: ms per
    call and device us per launch."""
    import torch
    from repro_torch.kernels.capscore import ops

    out = {"capscore_agg": {}, "capscore_multi": {}}
    chunks = {kind: cs._agg_inputs(device, rng, 2048, 4, kind) for kind in ("zipf", "one_key")}
    # the warm ingest's lanes: every tau finite (phase 2's first lane has tau = inf)
    finite = torch.tensor([2e-3, 0.5, 1e-3, 2e-3], dtype=torch.float32, device=device)
    chunks["zipf_finite_tau"] = chunks["zipf"][:5] + (finite, cs.SALT)
    for kind, args in chunks.items():
        rows = out["capscore_agg"][kind] = {name: {"ms": [], "device_us": []} for name in AGGS}
        want = ops.capscore_agg_ref(*args)
        for _ in range(2):
            for name in AGGS:
                use_library("capscore_agg", ops._SIGNATURES, built[name])
                got = ops.capscore_agg_cuda(*args)
                torch.cuda.synchronize()
                for i in (1, 3, 4):
                    if not torch.equal(got[i], want[i]):
                        raise AssertionError(f"capscore_agg {name} differs from the plain version")
                for i in (0, 2):
                    if not torch.allclose(got[i], want[i], rtol=1e-5, atol=0):
                        raise AssertionError(f"capscore_agg {name} beyond rtol 1e-5")
                call = lambda: ops.capscore_agg_cuda(*args)  # noqa: E731
                rows[name]["ms"].append(cs.cuda_ms(call))
                rows[name]["device_us"].append(cs._device_profile(
                    call, 50, "capscore_agg_kernel")["kernel_device_us_per_launch"])
        for name in AGGS:
            cs.log(f"capscore_agg C=2048 L=4 {kind} {name}: {json.dumps(rows[name])}")
    for N in (1 << 20, 2048):
        elems, ls, taus = cs._score_inputs(device, rng, N, 4)
        want = ops.capscore_multi_ref(*elems, ls, taus, cs.SALT)
        rows = out["capscore_multi"][N] = {name: {"ms": [], "device_us": []} for name in SCORES}
        it = (50, 5) if N > 65536 else (200, 20)
        for _ in range(2):
            for name in SCORES:
                use_library("capscore", ops._SCORE_SIGNATURES, built[name])
                got = ops.capscore_multi_cuda(*elems, ls, taus, cs.SALT)
                torch.cuda.synchronize()
                if not all(cs._same_bits(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"capscore_multi {name} differs from the plain version")
                call = lambda: ops.capscore_multi_cuda(*elems, ls, taus, cs.SALT)  # noqa: E731
                rows[name]["ms"].append(cs.cuda_ms(call, *it))
                rows[name]["device_us"].append(cs._device_profile(
                    call, 20, "capscore_multi_kernel")["kernel_device_us_per_launch"])
        for name in SCORES:
            cs.log(f"capscore_multi N={N} L=4 {name}: {json.dumps(rows[name])}")
    return out


def bag_inputs(rng, device, B: int) -> dict:
    """serve-shaped pooling: B bags of 50 Zipf(1.2) ids, 10% padding."""
    import torch
    from repro_torch.data.streams import zipf_keys

    N = B * BAG_LEN
    ids = torch.from_numpy(zipf_keys(rng, N, 1.2, BAG_TABLE_ROWS).astype("int32")).to(device)
    ids[torch.from_numpy(rng.random(N) < 0.1).to(device)] = -1
    bags = torch.arange(B, device=device)[:, None].expand(B, BAG_LEN).reshape(-1)
    return {"ids": ids, "bags": bags, "B": B}


def time_bags(cs, rng, device, built, seed: int, result: dict) -> None:
    """The embedding_bag variants at both pooling shapes, in turns, twice."""
    import torch
    from repro_torch.kernels.embedding_bag import ops as eops

    table = torch.randn((BAG_TABLE_ROWS, 256), device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    for shape, B in BAG_SHAPES.items():
        x = bag_inputs(rng, device, B)
        want = cs._bag_plain(eops, table, x["ids"], B, BAG_LEN)
        it = (10, 3) if B > 10_000 else (200, 20)
        rows = result[shape] = {}

        def call():
            return eops.embedding_bag_cuda(table, x["ids"], x["bags"], n_bags=B,
                                           mode="mean", sorted_bags=True)
        for name in BAGS:
            rows[name] = {"ms": []}
        for _ in range(2):
            for name in BAGS:
                use_bag_library(built[name])
                got = call()
                torch.cuda.synchronize()
                rows[name]["max_abs_err"] = cs._segsum_error(got, want)
                rows[name]["ms"].append(cs.cuda_ms(call, *it))
                rows[name]["device_us_per_launch"] = cs._device_profile(
                    call, 5, "embedding_bag_kernel")["kernel_device_us_per_launch"]
        for name in BAGS:
            cs.log(f"embedding_bag {shape} (B={B}) {name}: {json.dumps(rows[name])}")
        del x, want
    del table
    torch.cuda.empty_cache()


def time_sorts(cs, rng, device, built, rows: dict) -> None:
    """The chunk sorts and torch.sort on one Zipf chunk, in turns, twice."""
    import numpy as np
    import torch
    from repro_torch.data.streams import zipf_keys
    from repro_torch.kernels.chunksort import ops as sops

    keys = torch.from_numpy(zipf_keys(rng, 2048, 1.2, 1 << 22).astype(np.int32)).to(device)
    want = sops.sort_with_perm_ref(keys)
    for name in (*SORTS, "torch.sort"):
        rows[name] = {"ms": []}
    for _ in range(2):
        for name in SORTS:
            use_sort_library(built[name])
            got = sops.sort_with_perm_cuda(keys)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"chunksort {name} differs from torch.sort(stable=True)")
            rows[name]["ms"].append(cs.cuda_ms(lambda: sops.sort_with_perm_cuda(keys)))
            prof = cs._device_profile(lambda: sops.sort_with_perm_cuda(keys), 50, "")
            rows[name]["device_us_per_call"] = prof["device_busy_ms_per_call"] * 1e3
            rows[name]["kernel_launches_per_call"] = prof["kernel_launches_per_call"]
        lib_call = lambda: torch.sort(keys, stable=True)  # noqa: E731
        rows["torch.sort"]["ms"].append(cs.cuda_ms(lib_call))
        prof = cs._device_profile(lib_call, 50, "")
        rows["torch.sort"]["device_us_per_call"] = prof["device_busy_ms_per_call"] * 1e3
        rows["torch.sort"]["kernel_launches_per_call"] = prof["kernel_launches_per_call"]
    for name, row in rows.items():
        cs.log(f"chunksort n=2048 {name}: {json.dumps(row)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=tuple(PARTS), action="append",
                    help="time only these kernels' variants (repeatable; default all)")
    args = ap.parse_args(argv)
    parts = args.only or tuple(PARTS)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(ROOT)]
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}")
    cs.exact_f32()
    device = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    result = {"card": smi, "embedding_bag": {}, "chunksort": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = build(Path(tmp), [n for part in parts for n in PARTS[part]])
        if "capscore" in parts:
            result.update(time_capscore(cs, rng, device, built))
        if "embedding_bag" in parts:
            time_bags(cs, rng, device, built, args.seed, result["embedding_bag"])
        if "chunksort" in parts:
            time_sorts(cs, rng, device, built, result["chunksort"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "kernel_variants.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
