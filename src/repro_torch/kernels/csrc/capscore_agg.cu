// Fused multi-lane scoring + per-key reduction of a key-sorted stream chunk.
//
// Replaces the TPU kernel repro/kernels/capscore/capscore.py `capscore_agg`
// (`_make_capscore_agg_kernel`).  For every l lane it scores each element of
// the key-sorted chunk (two uint32 avalanche hashes -> u, e = -log1p(-u),
// KeyBase, score, Delta, entry gate; paper eq. 10 and Algorithm 4) and
// reduces per key: w_total, entered, contrib (count from the first entry
// onward), kb_min and min_score.
//
// Design: one warp owns one segment (run of equal keys; `seg` is sorted, so
// a segment's elements are contiguous and a binary search finds its bounds).
// Warp w writes output row w, so rows past the last segment get the
// reduction identities from warps that find no elements.  The warp hashes
// each element once per group of 8 lanes and walks its segment twice per
// group: the first walk finds the first entry event (min element index) and
// min_score, the second sums the weight after that entry.  Reductions are
// per-thread in index order then a fixed butterfly over the warp: no
// atomics, no carry between blocks, deterministic.  The TPU kernel's
// one-hot matmul sums and its sequential-grid carry do not carry over.
//
// Exactness: entered, kb_min and min_score equal the plain PyTorch version
// bit for bit (same IEEE divisions in the same order — ku / l, not
// ku * (1/l) — and the same libdevice log1pf PyTorch's CUDA log1p calls;
// build without --use_fast_math).  w_total and contrib are f32 sums taken in
// another order than the plain version's scatter-add.
//
// What bounds it on an H100: at the main path's C = 2048, L = 4 it reads
// 16 B per element and writes (4 + 13 L) B per row, about 140 KB in all,
// which is well under a microsecond of memory time; launch latency and the
// warps' serial walk over the largest segment dominate.
#include <cuda_runtime.h>
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
    // no live element in this row: the reduction identities
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
  // KeyBase is per key: the whole segment shares it
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
    // walk 1: score every element, first entry event and min score per lane
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
          // i rises along this thread's walk: its first entry is its min
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
    // walk 2: weight of the elements after each lane's first entry
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

// ks, eids, seg: int32 [C]; ws: f32 [C] (the key-sorted chunk view);
// ls, taus: f32 [L] on the device.  Outputs: w_total f32 [C]; entered u8,
// contrib, kb_min, min_score f32, each [L, C] row-major.
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
