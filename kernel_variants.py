#!/usr/bin/env python3
"""Build variants of the ``embedding_bag`` and ``chunksort`` kernels and time
each at the main path's shapes: what each design choice is worth on the card.

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

Every variant is held against the plain version first (``embedding_bag_ref``
within rtol 1e-5 / atol 1e-5 max|want|; ``chunksort`` bit-identical).  Times:
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
SORTS = ("registers", "registers_select", "smem_bitonic", "radix4", "radix6")
BAGS = (*BAG_ROWS, "rows1_vec4")


def build(out_dir: Path) -> dict[str, Path]:
    """One nvcc per variant, all at once; returns name -> library."""
    from repro_torch.kernels import _build

    jobs = {}
    for name, (source, edits) in VARIANTS.items():
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
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        built[name] = lib
    return built


def use_bag_library(path: Path) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in ops._BAG_SIGNATURES.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    _build._LIBS["embedding_bag"] = lib


def use_sort_library(path: Path) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunksort import ops

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in ops._SIGNATURES.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    _build._LIBS["chunksort"] = lib
    ops._library.cache_clear()


def bag_inputs(rng, device, B: int) -> dict:
    """serve-shaped pooling: B bags of 50 Zipf(1.2) ids, 10% padding."""
    import torch
    from repro_torch.data.streams import zipf_keys

    N = B * BAG_LEN
    ids = torch.from_numpy(zipf_keys(rng, N, 1.2, BAG_TABLE_ROWS).astype("int32")).to(device)
    ids[torch.from_numpy(rng.random(N) < 0.1).to(device)] = -1
    bags = torch.arange(B, device=device)[:, None].expand(B, BAG_LEN).reshape(-1)
    return {"ids": ids, "bags": bags, "B": B}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.data.streams import zipf_keys
    from repro_torch.kernels.chunksort import ops as sops
    from repro_torch.kernels.embedding_bag import ops as eops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}")
    cs.exact_f32()
    device = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    result = {"card": smi, "embedding_bag": {}, "chunksort": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = build(Path(tmp))

        table = torch.randn((BAG_TABLE_ROWS, 256), device=device,
                            generator=torch.Generator(device=device).manual_seed(args.seed))
        for shape, B in BAG_SHAPES.items():
            x = bag_inputs(rng, device, B)
            want = cs._bag_plain(eops, table, x["ids"], B, BAG_LEN)
            it = (10, 3) if B > 10_000 else (200, 20)
            rows = result["embedding_bag"][shape] = {}

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

        keys = torch.from_numpy(zipf_keys(rng, 2048, 1.2, 1 << 22).astype(np.int32)).to(device)
        want = sops.sort_with_perm_ref(keys)
        rows = result["chunksort"]
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
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "kernel_variants.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
