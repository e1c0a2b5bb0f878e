// Element-wise capped scoring of a stream chunk, for one l lane or many.
//
// Replaces the TPU kernels repro/kernels/capscore/capscore.py `capscore_multi`
// (`_make_capscore_multi_kernel`) and `capscore` (`_capscore_kernel`).  Per
// element: two uint32 avalanche hashes give u = U(eid) and Hash(key); then
// e = -log1p(-u), v = e / w and, per lane (l, tau), KeyBase kb = Hash(key) / l,
// score = v <= 1/l ? kb : v, Delta = e / max(1/l, tau) and the entry flag
// (Delta < w and (tau * l > 1 or kb < tau)) — paper eq. 10, Algorithm 4.
//
// Design: one thread per element, grid-stride.  The element's hashes, e and
// v are computed once and every lane reuses them (the TPU kernel kept them in
// VMEM across lanes for the same reason).  Lane j's outputs go to row j of
// the [L, N] outputs at [j * N + i], so each row is written coalesced.  The
// multi-lane entry point reads (ls, taus) from device memory; the single-lane
// one takes (l, tau, salt) by value, so no device scalar is ever made.
//
// Exactness: the plain PyTorch versions (kernels/capscore/ref.py) do the same
// IEEE f32 operations in the same order — ku / l is a division, never
// ku * (1/l); every literal is f32, so nothing is widened to double; no
// expression has the a * b + c shape nvcc would contract into an FMA; and
// log1pf is the libdevice function PyTorch's CUDA log1p calls (build without
// --use_fast_math).  So all four outputs equal the plain version bit for bit.
//
// What bounds it on an H100: it reads 12 B and writes 16 B per lane per
// element; at the distributed pass I's shape (N = 2048, L = 4) that is about
// 156 KB, 0.05 us at 3.35 TB/s, and some 100 integer and float operations per
// element.  Both are far below a launch's latency, which sets its time.
#include <cuda_runtime.h>
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

// one lane's (score, delta, entry, kb) of an element
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

// keys, eids: int32 [n]; weights: f32 [n]; ls, taus: f32 [L] on the device.
// Outputs score, delta, kb: f32 [L, n]; entry: int32 [L, n]; row-major.
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

// keys, eids: int32 [n]; weights: f32 [n]; (l, tau, salt) by value.
// Outputs score, delta: f32 [n]; entry: int32 [n].
extern "C" int capscore_launch(const int* keys, const int* eids,
                               const float* weights, int n, float l, float tau,
                               unsigned int salt, float* score, float* delta,
                               int* entry, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  capscore_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      keys, eids, weights, n, l, tau, salt, score, delta, entry);
  return static_cast<int>(cudaGetLastError());
}
