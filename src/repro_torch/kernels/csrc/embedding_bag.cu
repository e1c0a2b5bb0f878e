// EmbeddingBag with the gather fused in: out[b] = sum of table[ids[n]] over
// the non-padding ids n of bag b, optionally weighted, optionally divided by
// the bag's count of non-padding ids.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/embedding_bag.py
// `segment_sum` on the path that pools bags (repro/kernels/embedding_bag/
// ops.py `embedding_bag`: a gather of the rows, then the segment sum).  The
// TPU kernel sums gathered rows as a one-hot matmul into a VMEM-resident
// accumulator; on Hopper the gather itself is the cost, so this kernel reads
// each row straight from the table and never writes the gathered rows out.
//
// What it computes, exactly as the plain version embedding_bag_ref: a row is
// table[min(id, V - 1)], times per_sample_weights[n] where given (in f32, or
// rounded to the table's dtype where the weights have that dtype, as
// PyTorch's product of two such tensors is); ids < 0 are padding and add
// nothing; each bag's rows are summed in f64 in ascending row order and
// rounded once to f32; "mean" divides that f32 sum by max(count, 1) in f32,
// where count is the bag's number of non-padding ids, counted in the same
// pass.
//
// Bags are ranges [offsets[b], offsets[b+1]) of positions: the identity
// (perm == nullptr) where the bag ids are non-decreasing, or the positions
// of a stable sort of the bag ids (perm).  The wrapper
// (kernels/embedding_bag/ops.py) computes them on the device.
//
// Design: one warp per (bag, column tile of 32 * VEC columns), no atomics,
// so two launches give the same bits.  The lanes load 32 of the bag's ids
// at a time (coalesced), a ballot keeps the non-padding ones, and the warp
// walks them in ascending order, one row at a time: each lane loads its VEC
// columns of the row (16-byte loads where the row allows; VEC = 8 covers a
// 256-column row with one warp) and adds them into its f64 registers.
// Holding 2 to 16 rows in flight per warp measured slower at serve_bulk's
// pooling (kernel_variants.py): each row in flight costs a lane VEC
// registers, and more warps per SM keep more loads in flight in all.  A
// padding id is skipped by the whole warp at once; nothing is compacted or
// copied.
//
// What bounds it on an H100: bytes.  Every non-padding row is read once
// (D * sizeof(T) bytes, a random row of the table), the ids once, out
// written once: serve_bulk's 11.8 M non-padding ids of 256 f32 columns read
// 12 GB, 3.6 ms at 3.35 TB/s.  Zipf-hot rows repeat across bags and may hit
// in L2.  A bag is walked by its warps alone, so a bag of millions of rows
// would be walked serially (no serving bag is: they hold 50 ids).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// x rounded to T and back: a product of two T values, as PyTorch rounds it
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half(x));
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// VEC consecutive columns of one row, in loads of up to 16 bytes
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC]) {
  constexpr int BYTES = VEC * sizeof(T) < 16 ? VEC * sizeof(T) : 16;
  constexpr int PER = BYTES / sizeof(T);
  using R = typename Raw<BYTES>::type;
#pragma unroll
  for (int q = 0; q < VEC / PER; ++q) {
    const R raw = __ldg(reinterpret_cast<const R*>(p) + q);
    T x[PER];
    memcpy(x, &raw, BYTES);
#pragma unroll
    for (int k = 0; k < PER; ++k) v[q * PER + k] = to_f32(x[k]);
  }
}

// wkind: 0 no weights, 1 f32 weights (f32 products), 2 weights of the
// table's dtype T (products rounded to T)
template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ table, int64_t V, int64_t row_stride, int D,
                     int tiles, const I* __restrict__ ids, const int64_t* __restrict__ perm,
                     const int64_t* __restrict__ offsets, int64_t S,
                     const void* __restrict__ weights, int wkind, int mean,
                     float* __restrict__ out) {
  const int64_t warp = (int64_t(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S * tiles) return;  // whole warps only
  const int64_t s = warp / tiles;
  const int col = (int(warp % tiles) * 32 + lane) * VEC;
  const bool active = col < D;  // lanes past a ragged D still shuffle
  const int64_t lo = offsets[s];
  const int64_t hi = offsets[s + 1];
  double acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0;
  int count = 0;
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t p = base + lane;
    long long row = -1;
    float w = 1.0f;
    if (p < hi) {
      const int64_t n = perm ? perm[p] : p;
      const int64_t id = static_cast<int64_t>(ids[n]);
      if (id >= 0) {
        row = id < V ? id : V - 1;
        if (wkind == 1) w = static_cast<const float*>(weights)[n];
        else if (wkind == 2) w = to_f32(static_cast<const T*>(weights)[n]);
      }
    }
    unsigned live = __ballot_sync(FULL, row >= 0);  // ascending positions
    count += __popc(live);
    while (live) {  // warp-uniform
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
    }
  }
  if (!active) return;
  float res[VEC];
  const float denom = float(count > 1 ? count : 1);
#pragma unroll
  for (int k = 0; k < VEC; ++k) res[k] = mean ? float(acc[k]) / denom : float(acc[k]);
  float* o = out + s * D + col;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      reinterpret_cast<float4*>(o)[k / 4] =
          make_float4(res[k], res[k + 1], res[k + 2], res[k + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(res[0], res[1]);
  } else {
    o[0] = res[0];
  }
}

template <typename T, int VEC, typename I>
cudaError_t launch(const void* table, int64_t V, int64_t row_stride, int D, const void* ids,
                   const int64_t* perm, const int64_t* offsets, int64_t S,
                   const void* weights, int wkind, int mean, float* out,
                   cudaStream_t stream) {
  const int tiles = (D + 32 * VEC - 1) / (32 * VEC);
  const int64_t threads = S * tiles * 32;
  const int64_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, VEC, I><<<unsigned(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(table), V, row_stride, D, tiles, static_cast<const I*>(ids),
      perm, offsets, S, weights, wkind, mean, out);
  return cudaGetLastError();
}

// The widest VEC in {MAX_VEC, ..., 1} that D, the row stride and the
// pointers allow, where a warp's 32 * VEC columns fit in D.
template <typename T, int MAX_VEC, typename I>
cudaError_t dispatch(const void* table, int64_t V, int64_t row_stride, int D, const void* ids,
                     const int64_t* perm, const int64_t* offsets, int64_t S,
                     const void* weights, int wkind, int mean, float* out,
                     cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      static_cast<uintptr_t>(row_stride * sizeof(T));
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out);
  const auto fits = [&](int vec) {
    return D % vec == 0 && D >= 32 * vec && a % (vec * sizeof(T)) == 0 &&
           ao % (vec >= 4 ? 16 : 4 * vec) == 0;
  };
  if constexpr (MAX_VEC >= 8) {
    if (fits(8))
      return launch<T, 8, I>(table, V, row_stride, D, ids, perm, offsets, S, weights, wkind,
                             mean, out, stream);
  }
  if (fits(4))
    return launch<T, 4, I>(table, V, row_stride, D, ids, perm, offsets, S, weights, wkind,
                           mean, out, stream);
  if (fits(2))
    return launch<T, 2, I>(table, V, row_stride, D, ids, perm, offsets, S, weights, wkind,
                           mean, out, stream);
  return launch<T, 1, I>(table, V, row_stride, D, ids, perm, offsets, S, weights, wkind, mean,
                         out, stream);
}

template <typename I>
cudaError_t by_dtype(const void* table, int dtype, int64_t V, int64_t row_stride, int D,
                     const void* ids, const int64_t* perm, const int64_t* offsets, int64_t S,
                     const void* weights, int wkind, int mean, float* out,
                     cudaStream_t stream) {
  if (dtype == 0)
    return dispatch<float, 8, I>(table, V, row_stride, D, ids, perm, offsets, S, weights,
                                 wkind, mean, out, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, 8, I>(table, V, row_stride, D, ids, perm, offsets, S,
                                         weights, wkind, mean, out, stream);
  if (dtype == 2)
    return dispatch<__half, 8, I>(table, V, row_stride, D, ids, perm, offsets, S, weights,
                                  wkind, mean, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// table: [V, D] with rows row_stride elements apart (unit column stride),
// dtype 0 = f32, 1 = bf16, 2 = f16.  ids: [N] int32 (ids_int64 = 0) or int64.
// perm: [N] int64 positions in grouped order, or nullptr for the identity.
// offsets: [S + 1] int64, bag b owns positions [offsets[b], offsets[b+1]).
// weights: [N] f32 (wkind 1), of the table's dtype (wkind 2), or nullptr
// (wkind 0).  mean: divide by the count.  out: [S, D] f32.  Returns the
// launch's CUDA error code.
extern "C" int embedding_bag_launch(const void* table, int dtype, long long V,
                                    long long row_stride, int D, const void* ids,
                                    int ids_int64, const int64_t* perm,
                                    const int64_t* offsets, long long S,
                                    const void* weights, int wkind, int mean, float* out,
                                    cudaStream_t stream) {
  if (S <= 0 || D <= 0) return 0;
  if (V <= 0 || (wkind != 0) != (weights != nullptr)) return int(cudaErrorInvalidValue);
  const cudaError_t err =
      ids_int64 ? by_dtype<int64_t>(table, dtype, V, row_stride, D, ids, perm, offsets, S,
                                    weights, wkind, mean, out, stream)
                : by_dtype<int32_t>(table, dtype, V, row_stride, D, ids, perm, offsets, S,
                                    weights, wkind, mean, out, stream);
  return int(err);
}
