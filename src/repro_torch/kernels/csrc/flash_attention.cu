// Blockwise (FlashAttention-style) causal or non-causal GQA attention,
// forward only, for f32 inputs on the FMA units.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// `flash_attention` (`_flash_kernel`) for float32; bfloat16 inputs go to the
// tensor-core kernel in flash_attention_sm90.cu.  It computes what that
// kernel computes: q [B,Hq,S,D] and k, v [B,Hkv,S,D]; q head h reads kv head
// h / (Hq/Hkv); q is scaled by 1/sqrt(D) before QK^T; masked scores are set
// to NEG_INF = -1e30; the online softmax keeps m, l and acc in f32 across kv
// tiles; the output is acc / l.  A ragged S (not a multiple of the tile) is
// masked here: kv rows past S score NEG_INF and q rows past S are not stored.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch).
// The TPU kernel walked its grid in order and kept a whole K/V stream of one
// head in VMEM; here the blocks run in parallel and each loops over its kv
// tiles of 64 rows up to the causal bound ceil((q_start + 64) / 64), staging
// one tile at a time in shared memory (87 KB of dynamic shared memory at
// D = 128, so two blocks fit on an SM).  The q tile sits in shared memory,
// transposed and pre-scaled; the K tile is stored transposed, so the QK^T
// loop reads four q rows and four kv columns as two float4 per d.  Thread
// (ty, tx) owns q rows 4ty..4ty+3: it holds a 4x4 block of scores and 4 x D/16
// output columns in registers; the row max and row sum run over the 16 lanes
// that share ty (one half-warp, shuffles only).  The probabilities go through
// shared memory once per tile for P.V, whose V tile reuses K's buffer.
// Strides come from the caller (d must be contiguous), so the [B,S,H,D]
// projections of a prefill are read and the output written in place, with no
// transpose copies.
//
// What bounds it on an H100: at the serving prefill's shape (B=4, Hq=32,
// Hkv=4, S=4096, D=128, causal) the work is 4*B*Hq*S^2*D/2 = 5.5e11 FLOP,
// 8.2 ms at the 67 TFLOP/s of the f32 FMA units, against ~600 MB, 0.18 ms at
// 3.35 TB/s: compute bounds it.  The products stay on the FMA units because
// f32 must match the reference to 2e-5, which TF32 tensor cores (about three
// decimal digits) cannot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // kv rows per tile
constexpr int THREADS = 256;
constexpr int TS = BQ + 4;   // row stride (floats) of the transposed q/K tiles and of P
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the thread map gives 4 rows and 4 columns of a 64x64 tile");

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  long long b, h, s;  // element strides; d is contiguous
};

// Output column c of thread tx: D >= 64 gives each thread groups of four
// neighbouring columns (float4 reads of V), narrower heads one column per 16.
template <int D>
__device__ __forceinline__ int out_col(int c, int tx) {
  if constexpr (D >= 64) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else {
    return c * 16 + tx;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int S, int group, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, int causal) {
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][TS]: q * scale, transposed
  float* kv = qt + D * TS;                       // [D][TS] K transposed, then [BK][D] V
  float* ps = kv + D * TS;                       // [BQ][TS] probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;
  const int ty = (tid >> 5) * 2 + (lane >> 4);

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / group) * sk.h;
  const T* vb = v + b * sv.b + (h / group) * sv.h;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    qt[d * TS + r] = (q0 + r < S) ? to_f32(qb[(q0 + r) * sq.s + d]) * scale : 0.0f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int n_tiles = (S + BK - 1) / BK;
  const int upper = causal ? min(n_tiles, (q0 + BQ + BK - 1) / BK) : n_tiles;
  for (int j = 0; j < upper; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's P.V reads are done (and q is stored)
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx % D;
      kv[d * TS + c] = (k0 + c < S) ? to_f32(kb[(k0 + c) * sk.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * TS + ty * 4);
      const float4 c4 = *reinterpret_cast<const float4*>(kv + d * TS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], cv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx * 4 + jj;
        if (kpos >= S || (causal && qpos < kpos)) s[i][jj] = NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        rs += s[i][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * TS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();  // every QK^T read of the K tile is done; P is visible

    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx % D;
      kv[c * D + d] = (k0 + c < S) ? to_f32(vb[(k0 + c) * sv.s + d]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * TS + kk);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = kv + (kk + u) * D;
        float vv[NC];
        if constexpr (D >= 64) {
#pragma unroll
          for (int g = 0; g < NC / 4; ++g) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
            vv[g * 4 + 0] = t.x;
            vv[g * 4 + 1] = t.y;
            vv[g * 4 + 2] = t.z;
            vv[g * 4 + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) vv[c] = vrow[out_col<D>(c, tx)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i][u], vv[c], acc[i][c]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[r * so.s + out_col<D>(c, tx)] = from_f32<T>(acc[i][c] / l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int group, int S, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = (2 * D * TS + BQ * TS) * sizeof(float);
  // the attribute belongs to the current device, so it is set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, group, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order; d is
// contiguous in all four.  f32 only.  Returns the launch's cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int S, int D,
                                      const long long* strides, float scale, int causal,
                                      void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1) return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<float, 16>(q, k, v, o, B, Hq, group, S, strides, scale, causal, st);
    case 32: return launch<float, 32>(q, k, v, o, B, Hq, group, S, strides, scale, causal, st);
    case 64: return launch<float, 64>(q, k, v, o, B, Hq, group, S, strides, scale, causal, st);
    case 128: return launch<float, 128>(q, k, v, o, B, Hq, group, S, strides, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
