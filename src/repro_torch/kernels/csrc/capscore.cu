// Element-wise capped scoring of a stream chunk, for one l lane or many.
//
// Replaces the TPU kernels repro/kernels/capscore/capscore.py `capscore_multi`
// (`_make_capscore_multi_kernel`) and `capscore` (`_capscore_kernel`).  Per
// element: two uint32 avalanche hashes give u = U(eid) and Hash(key); then
// e = -log1p(-u), v = e / w and, per lane (l, tau), KeyBase kb = Hash(key) / l,
// score = v <= 1/l ? kb : v, Delta = e / max(1/l, tau) and the entry flag
// (Delta < w and (tau * l > 1 or kb < tau)) — paper eq. 10, Algorithm 4.
//
// Design: capscore_multi, the pass-I kernel, takes 4 consecutive elements per
// thread in a grid-stride loop over at most 8 blocks of 256 threads per SM
// (full occupancy).  Keys, eids and weights come in as one 16-byte load
// each, and each lane's four results go out as one 16-byte store into row j
// of each [L, N] output, at [j * N + i], so every row is written coalesced.
// The element's hashes, e and v are computed once and every lane reuses
// them (the TPU kernel kept them in VMEM across lanes for the same reason).
// A base pointer off a 16-byte boundary (a view at an odd offset), a row of
// an output that starts off one (N not a multiple of 4), and the ragged
// tail take scalar loads or stores of the same values.  capscore, whose
// caller scores one 2048-element chunk per launch, keeps one element per
// thread, so those few elements still spread over 8 blocks.  The
// multi-lane entry point reads (ls, taus) from device memory; the
// single-lane one takes (l, tau, salt) by value, so no device scalar is
// ever made.
//
// Exactness: the plain PyTorch versions (kernels/capscore/ref.py) do the same
// IEEE f32 operations in the same order — ku / l is a division, never
// ku * (1/l); every literal is f32, so nothing is widened to double; no
// expression has the a * b + c shape nvcc would contract into an FMA; and
// log1pf is the libdevice function PyTorch's CUDA log1p calls (build without
// --use_fast_math).  So all four outputs equal the plain version bit for bit.
//
// What bounds it on an H100: it reads 12 B and writes 16 B per lane per
// element.  At distributed pass I's launch of 2^20 elements and L = 4 that
// is 79.7 MB, 23.8 us at 3.35 TB/s, above its some 110 + 10 L integer and
// float operations per element (2.3 us at 67 TFLOP/s): bandwidth-bound.  At
// one 2048-element chunk (the single-lane caller, vectorized.element_scores)
// the bytes take 0.05 us and a launch's latency sets its time.
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
constexpr int VEC = 4;                // capscore_multi's elements per thread
constexpr int MAX_BLOCKS = 132 * 8;   // 2048 threads per SM: full occupancy

struct Element {
  float w, e, v, ku;
};

__device__ __forceinline__ Element element(int key, int eid, float w, uint32_t salt) {
  Element x;
  x.w = w;
  const float u = u01(hash3(static_cast<uint32_t>(eid), SALT_ELEM, salt));
  x.e = -log1pf(-u);
  x.v = x.e / x.w;
  x.ku = u01(hash3(static_cast<uint32_t>(key), SALT_KEYBASE, salt));
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ int as_int(int x) { return x; }
__device__ __forceinline__ int as_int(float x) { return __float_as_int(x); }
template <typename T> __device__ __forceinline__ T from_int(int x);
template <> __device__ __forceinline__ int from_int<int>(int x) { return x; }
template <> __device__ __forceinline__ float from_int<float>(int x) { return __int_as_float(x); }

// elements i .. i + cnt - 1 (cnt <= VEC; one 16-byte load where it can)
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, long long i,
                                         int cnt, bool vec, T (&out)[VEC]) {
  if (vec && cnt == VEC) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p + i));
    out[0] = from_int<T>(a.x);
    out[1] = from_int<T>(a.y);
    out[2] = from_int<T>(a.z);
    out[3] = from_int<T>(a.w);
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = k < cnt ? p[i + k] : T(0);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, long long i, int cnt,
                                          const T (&v)[VEC]) {
  if (cnt == VEC && aligned16(p + i)) {
    *reinterpret_cast<int4*>(p + i) =
        make_int4(as_int(v[0]), as_int(v[1]), as_int(v[2]), as_int(v[3]));
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (k < cnt) p[i + k] = v[k];
  }
}

__global__ void __launch_bounds__(THREADS)
capscore_multi_kernel(const int* __restrict__ keys, const int* __restrict__ eids,
                      const float* __restrict__ weights, int n,
                      const float* __restrict__ ls,
                      const float* __restrict__ taus, int L, uint32_t salt,
                      float* __restrict__ score, float* __restrict__ delta,
                      int* __restrict__ entry, float* __restrict__ kb) {
  const bool vec = aligned16(keys) && aligned16(eids) && aligned16(weights);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * VEC;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
       i < n; i += stride) {
    // the group of elements at i: cnt of them, hashed once
    const int cnt = n - i < VEC ? static_cast<int>(n - i) : VEC;
    int kk[VEC], ee[VEC];
    float ww[VEC];
    load_vec(keys, i, cnt, vec, kk);
    load_vec(eids, i, cnt, vec, ee);
    load_vec(weights, i, cnt, vec, ww);
    Element x[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = element(kk[q], ee[q], q < cnt ? ww[q] : 1.0f, salt);
    for (int j = 0; j < L; ++j) {
      const float l = ls[j], tau = taus[j];
      float s[VEC], d[VEC], k[VEC];
      int en[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) score_lane(x[q], l, tau, &s[q], &d[q], &en[q], &k[q]);
      const long long o = static_cast<long long>(j) * n + i;
      store_vec(score, o, cnt, s);
      store_vec(delta, o, cnt, d);
      store_vec(entry, o, cnt, en);
      store_vec(kb, o, cnt, k);
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
    const Element x = element(keys[i], eids[i], weights[i], salt);
    float k;
    score_lane(x, l, tau, score + i, delta + i, entry + i, &k);
  }
}

// blocks for n elements at `per_thread` each, grid-stride beyond MAX_BLOCKS
int blocks_for(int n, int per_thread) {
  const long long per_block = static_cast<long long>(THREADS) * per_thread;
  const long long b = (n + per_block - 1) / per_block;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
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
  capscore_multi_kernel<<<blocks_for(n, VEC), THREADS, 0, stream>>>(
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
  capscore_kernel<<<blocks_for(n, 1), THREADS, 0, stream>>>(
      keys, eids, weights, n, l, tau, salt, score, delta, entry);
  return static_cast<int>(cudaGetLastError());
}
