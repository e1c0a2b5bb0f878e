// Segmented row sum: out[s] = sum of vals[n] over the rows n of segment s.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/embedding_bag.py
// `segment_sum` (`_segment_sum_kernel`), the reduction of EmbeddingBag.  The
// TPU kernel recasts each 256-row block as a one-hot matmul and keeps the
// whole (S, D) accumulator in VMEM across a sequential grid, which caps S*D*4
// bytes at VMEM.  None of that carries over: Hopper blocks run in parallel
// and carry nothing between them, and the serving path reduces into 262,144
// bags, far beyond any on-chip accumulator.
//
// Design: a deterministic segmented reduction with no atomics.  The wrapper
// (kernels/embedding_bag/ops.py) groups the rows by segment with a stable
// order -- `perm`, or the identity (perm == nullptr) where the ids are
// already non-decreasing, as a bag's are -- and finds each segment's range
// [offsets[s], offsets[s+1]) in that order; rows whose id lies outside
// [0, S) sit outside every range and are dropped.  One warp owns one
// (segment, column tile): each lane keeps VEC consecutive columns (float4
// loads for f32 rows of D >= 128) and adds the segment's rows in ascending
// row order, UNROLL rows in flight, into f64 registers; then it rounds once
// and writes its columns of out[s] as f32.  An empty segment gets zeros.
// The sum order is fixed, so two launches on the same input are
// bit-identical; it is the order of the plain version's CPU `index_add_`.
//
// Why f64 sums: a sequential f32 sum drifts with the segment's length.
// Summed in f32, the Zipf scatter check (2^24 rows of N(0, 1) values, the
// hottest of 2^20 segments holding ~18% of them) came out 0.2177734375 away
// from the f32 plain version on an H100, outside its tolerance of 1e-5 of
// the largest sum.  In f64 a sum of up to millions of f32 rows stays far
// below an f32 ulp from the exact sum before its one rounding, and the
// extra adds cost nothing in a kernel bound by bytes.  The plain version
// sums in f64 too.
//
// What bounds it on an H100: bytes.  Each row is read once (N*D*4 bytes for
// f32 rows), the offsets and perm once, out written once: at the serving
// shapes 13,107,200 x 256 f32 rows into 262,144 bags read 13.4 GB, 4.1 ms
// at 3.35 TB/s.  A warp walks its segment serially, so a segment that holds
// a large share of the rows (a Zipf-hot id) is walked by one warp alone.
//
// A second entry, `segment_fold_launch`, replaces no TPU kernel.  The
// reference's pass II sums the sampled keys' weights with XLA's `.at[].add`,
// which on the CPU adds in element order, bit for bit `np.add.at`; on a card
// `scatter_add_` / `index_add_` add with atomics in an order that changes
// from run to run, which is exact only for integer weights.  The entry was
// added for determinism: acc[s] = (((acc[s] + v[i1]) + v[i2]) + ...) over
// the rows i1 < i2 < ... of slot s, in acc's own dtype (f32 or f64), in
// place -- a left fold, the same bits as the CPU's element-order fold, and
// not segment_sum's "f64 sum rounded once", which would give other bits for
// an f32 accumulator and across batches.  The wrapper groups the rows by a
// stable sort of the slot ids (no host sync) and passes `perm` and the
// ranges; one thread owns one slot and walks its range in order, FOLD_LOADS
// loads in flight ahead of the dependent adds.  Bound by bytes (each value,
// id and perm entry read once, acc read and written once), but a Zipf-hot
// slot is walked by one thread alone, so a batch whose hottest key holds a
// large share of the rows takes that one chain of dependent adds.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = to_f32(p[0]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ vals, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ offsets, int64_t S, int D, int tiles,
                   float* __restrict__ out) {
  const int64_t warp = (int64_t(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S * tiles) return;
  const int64_t s = warp / tiles;
  const int col = (int(warp % tiles) * 32 + lane) * VEC;
  if (col >= D) return;  // no warp-wide operation follows
  const int64_t lo = offsets[s];
  const int64_t hi = offsets[s + 1];
  double acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0;
  int64_t i = lo;
  for (; i + UNROLL <= hi; i += UNROLL) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t row = perm ? perm[i + u] : i + u;
      load_row<T, VEC>(vals + row * D + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += double(v[u][k]);  // ascending row order
    }
  }
  for (; i < hi; ++i) {
    const int64_t row = perm ? perm[i] : i;
    float v[VEC];
    load_row<T, VEC>(vals + row * D + col, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += double(v[k]);
  }
  float* o = out + s * D + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(float(acc[0]), float(acc[1]),
                                                float(acc[2]), float(acc[3]));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(float(acc[0]), float(acc[1]));
  } else {
    o[0] = float(acc[0]);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* vals, const int64_t* perm, const int64_t* offsets,
                   int64_t S, int D, float* out, cudaStream_t stream) {
  const int tiles = (D + 32 * VEC - 1) / (32 * VEC);
  const int64_t threads = S * tiles * 32;
  const int64_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  segment_sum_kernel<T, VEC><<<unsigned(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(vals), perm, offsets, S, D, tiles, out);
  return cudaGetLastError();
}


constexpr int FOLD_THREADS = 256;
constexpr int FOLD_LOADS = 8;

template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
segment_fold_kernel(const T* __restrict__ vals, const int64_t* __restrict__ perm,
                    const int64_t* __restrict__ offsets, int64_t S, T* __restrict__ acc) {
  const int64_t s = int64_t(blockIdx.x) * FOLD_THREADS + threadIdx.x;
  if (s >= S) return;
  const int64_t lo = offsets[s];
  const int64_t hi = offsets[s + 1];
  if (lo == hi) return;
  T a = acc[s];
  int64_t i = lo;
  for (; i + FOLD_LOADS <= hi; i += FOLD_LOADS) {
    T v[FOLD_LOADS];
#pragma unroll
    for (int u = 0; u < FOLD_LOADS; ++u) v[u] = __ldg(vals + perm[i + u]);
#pragma unroll
    for (int u = 0; u < FOLD_LOADS; ++u) a = a + v[u];  // row order, one rounding each
  }
  for (; i < hi; ++i) a = a + __ldg(vals + perm[i]);
  acc[s] = a;
}

}  // namespace

// vals: [N, D] row-major, dtype 0 = f32, 1 = bf16, 2 = f16.  perm: [N]
// int64 rows in grouped order, or nullptr for the identity.  offsets:
// [S + 1] int64, segment s owns positions [offsets[s], offsets[s+1]) of
// that order.  out: [S, D] f32.  Returns the launch's CUDA error code.
extern "C" int segment_sum_launch(const void* vals, int dtype, const int64_t* perm,
                                  const int64_t* offsets, long long S, int D,
                                  float* out, cudaStream_t stream) {
  if (S <= 0 || D <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out);
  cudaError_t err;
  if (dtype == 0) {
    if (D % 4 == 0 && D >= 128 && a % 16 == 0)
      err = launch<float, 4>(vals, perm, offsets, S, D, out, stream);
    else if (D % 2 == 0 && D >= 64 && a % 8 == 0)
      err = launch<float, 2>(vals, perm, offsets, S, D, out, stream);
    else
      err = launch<float, 1>(vals, perm, offsets, S, D, out, stream);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, 1>(vals, perm, offsets, S, D, out, stream);
  } else if (dtype == 2) {
    err = launch<__half, 1>(vals, perm, offsets, S, D, out, stream);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(err);
}

// vals: [N] in acc's dtype (0 = f32, 1 = f64).  perm: [N] int64 rows in
// slot order (a stable sort of the slot ids).  offsets: [S + 1] int64, slot
// s owns positions [offsets[s], offsets[s+1]) of perm.  acc: [S], folded in
// place.  Returns the launch's CUDA error code.
extern "C" int segment_fold_launch(const void* vals, int dtype, const int64_t* perm,
                                   const int64_t* offsets, long long S, void* acc,
                                   cudaStream_t stream) {
  if (S <= 0) return 0;
  const int64_t blocks = (S + FOLD_THREADS - 1) / FOLD_THREADS;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  if (dtype == 0) {
    segment_fold_kernel<float><<<unsigned(blocks), FOLD_THREADS, 0, stream>>>(
        static_cast<const float*>(vals), perm, offsets, S, static_cast<float*>(acc));
  } else if (dtype == 1) {
    segment_fold_kernel<double><<<unsigned(blocks), FOLD_THREADS, 0, stream>>>(
        static_cast<const double*>(vals), perm, offsets, S, static_cast<double*>(acc));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
