// Stable chunk sort of int32 keys: (ks, perm), the stable ascending argsort.
//
// Replaces the TPU kernel repro/kernels/chunksort/chunksort.py `sort_pairs`
// (block-local bitonic `_make_block_sort_kernel` + cross-block two-run merges
// `_make_merge_kernel`).  Pairs are compared lexicographically and every idx
// is distinct, so the sorted order IS the stable argsort: the output is
// bit-identical to torch.sort(stable=True) by construction.
//
// What bounds it on an H100: at the main path's 2048 keys the kernel moves
// 24 KB (8 ns at 3.35 TB/s), so what it costs is latency: the launch and the
// critical path of the network inside one CTA.
//
// n <= 2048, the ingest chunk (`sort_chunk`): one CTA of 256 threads sorts
// the whole chunk in registers.  A batch of chunks (`chunksort_sort_rows`,
// the multi-tenant bank's one chunk per tenant) is one launch of one such
// CTA per row, each row sorted on its own: perm holds indices within it.  Each (key, idx) pair is one 64-bit word,
// the key with its sign bit flipped in the high half and idx in the low
// half, so one unsigned compare orders pairs lexicographically.  Element i
// of the 2048-slot bitonic network lives in register i % 8 of thread i / 8
// (slots past n hold (EMPTY, i), which sort after every real pair).  Of the
// network's 66 compare-exchange stages, strides 1..4 run inside a thread's
// registers and strides 8..128 between the lanes of a warp (`__shfl_xor_sync`);
// only strides 256..1024 cross warps.  They come at the start of the merges
// of sizes 512, 1024 and 2048, which run them on a transposed layout
// (element i in register i / 256 of thread i % 256) reached through shared
// memory: six barriers in all, where the shared-memory network of larger
// inputs needs one per stage.  ks and perm are written once, each thread its
// eight consecutive outputs.
//
// n > 2048: the classic global bitonic sort over the padded power of two P.
// One CTA sorts each block of up to BLOCK = 4096 pairs (32 KB) in shared
// memory; the compare-exchange stages whose stride reaches past a block run
// as one launch each over global memory, and the stages with stride below
// the block finish in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMPTY_KEY = 0x7fffffff;

// --- n <= 2048: one CTA, the network in registers --------------------------

constexpr int LOG_N = 11;
constexpr int CHUNK = 1 << LOG_N;          // 2048 slots
constexpr int WORDS = 8;                   // registers (words) per thread
constexpr int CHUNK_THREADS = CHUNK / WORDS;  // 256
constexpr int LOG_WARP_SPAN = 8;           // strides >= 256 cross warps

__device__ __forceinline__ unsigned long long pack(int key, int idx) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(idx);
}

// The transposed layouts' shared-memory slot of element i: its low four bits
// XOR bits 4..7, so both layouts' 64-bit accesses are free of bank conflicts.
__device__ __forceinline__ int slot(int i) { return i ^ ((i >> 4) & 15); }

// One predicated swap: fewer selects than taking min and max, then
// ordering them (6.85 against 10.05 us per launch on an H100,
// kernel_variants.py)
__device__ __forceinline__ void exchange(unsigned long long& a, unsigned long long& b,
                                         bool ascending) {
  if ((a > b) == ascending) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

// CTA b sorts row b of keys [B, n] (B = 1: one chunk)
__global__ void __launch_bounds__(CHUNK_THREADS)
sort_chunk(const int* __restrict__ keys, int n, int* __restrict__ ks_out,
           long long* __restrict__ perm_out) {
  __shared__ unsigned long long sm[CHUNK];
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  keys += row;
  ks_out += row;
  perm_out += row;
  const int t = threadIdx.x;
  const int first = t * WORDS;  // element of register 0
  unsigned long long x[WORDS];
  if (first + WORDS <= n && (reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(keys + first));
    const int4 b = __ldg(reinterpret_cast<const int4*>(keys + first) + 1);
    const int k[WORDS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < WORDS; ++r) x[r] = pack(k[r], first + r);
  } else {
#pragma unroll
    for (int r = 0; r < WORDS; ++r) {
      const int i = first + r;
      x[r] = pack(i < n ? __ldg(keys + i) : EMPTY_KEY, i);
    }
  }

#pragma unroll
  for (int lk = 1; lk <= LOG_N; ++lk) {
    const int k = 1 << lk;  // merge size: element i ascends iff (i & k) == 0
    if (lk > LOG_WARP_SPAN) {
      // strides k/2 .. 256 on the transposed layout: element 256 r + t in x[r]
#pragma unroll
      for (int r = 0; r < WORDS; ++r) sm[slot(first + r)] = x[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < WORDS; ++r) x[r] = sm[slot(r * CHUNK_THREADS + t)];
#pragma unroll
      for (int lj = lk - 1; lj >= LOG_WARP_SPAN; --lj) {
        const int rj = 1 << (lj - LOG_WARP_SPAN);
#pragma unroll
        for (int r = 0; r < WORDS; ++r) {
          if ((r & rj) == 0)
            exchange(x[r], x[r | rj], ((r * CHUNK_THREADS) & k) == 0);
        }
      }
      // each thread writes back the slots it read: no barrier before this
#pragma unroll
      for (int r = 0; r < WORDS; ++r) sm[slot(r * CHUNK_THREADS + t)] = x[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < WORDS; ++r) x[r] = sm[slot(first + r)];
    }
#pragma unroll
    for (int lj = (lk > LOG_WARP_SPAN ? LOG_WARP_SPAN : lk) - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= WORDS) {
        // stride j: the partner is lane ^ (j / 8), same register
        const int lanes = j / WORDS;
        const bool upper = (t & lanes) != 0;
        const bool ascending = (first & k) == 0;  // k >= 16 here: one bit of t
#pragma unroll
        for (int r = 0; r < WORDS; ++r) {
          const unsigned long long y = __shfl_xor_sync(0xffffffffu, x[r], lanes);
          const bool take_lo = ascending != upper;
          x[r] = (x[r] < y) == take_lo ? x[r] : y;  // words are distinct
        }
      } else {
#pragma unroll
        for (int r = 0; r < WORDS; ++r) {
          if ((r & j) == 0) exchange(x[r], x[r | j], ((first + r) & k) == 0);
        }
      }
    }
  }

  if (first + WORDS <= n && (reinterpret_cast<uintptr_t>(ks_out) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(perm_out) & 15) == 0) {
    int k[WORDS];
#pragma unroll
    for (int r = 0; r < WORDS; ++r) k[r] = static_cast<int>((x[r] >> 32) ^ 0x80000000u);
    int4* ko = reinterpret_cast<int4*>(ks_out + first);
    ko[0] = make_int4(k[0], k[1], k[2], k[3]);
    ko[1] = make_int4(k[4], k[5], k[6], k[7]);
    longlong2* po = reinterpret_cast<longlong2*>(perm_out + first);
#pragma unroll
    for (int r = 0; r < WORDS; r += 2)
      po[r / 2] = make_longlong2(x[r] & 0xffffffffu, x[r + 1] & 0xffffffffu);
  } else {
#pragma unroll
    for (int r = 0; r < WORDS; ++r) {
      if (first + r < n) {
        ks_out[first + r] = static_cast<int>((x[r] >> 32) ^ 0x80000000u);
        perm_out[first + r] = static_cast<long long>(x[r] & 0xffffffffu);
      }
    }
  }
}

// --- n > 2048: global bitonic network over blocks of BLOCK pairs -----------

constexpr int BLOCK = 4096;    // pairs per CTA in shared memory
constexpr int THREADS = 1024;  // each thread owns BLOCK / 2 / THREADS exchanges

__device__ __forceinline__ bool pair_gt(int ka, int ia, int kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// All shared-memory stages of one block: sizes size_lo..size_hi (powers of
// two), strides size/2 .. 1, except that the first size may start at a
// smaller stride (stride_start) when the larger strides already ran in
// global memory.  A pair group is ascending iff bit `size` of its global
// index is clear.
__device__ void smem_stages(int* sk, int* si, int B, int base, int size_lo,
                            int size_hi, int stride_start) {
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    int stride = (size == size_lo) ? stride_start : size >> 1;
    for (; stride >= 1; stride >>= 1) {
      for (int p = threadIdx.x; p < (B >> 1); p += blockDim.x) {
        int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        int j = i + stride;
        bool asc = ((base + i) & size) == 0;
        int ka = sk[i], ia = si[i], kb = sk[j], ib = si[j];
        if (pair_gt(ka, ia, kb, ib) == asc) {
          sk[i] = kb; si[i] = ib; sk[j] = ka; si[j] = ia;
        }
      }
      __syncthreads();
    }
  }
}

__device__ void store(const int* sk, const int* si, int B, int base, int n,
                      int final_out, int* gk, int* gi, int* ks_out,
                      long long* perm_out) {
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    int g = base + t;
    if (final_out) {
      if (g < n) { ks_out[g] = sk[t]; perm_out[g] = si[t]; }
    } else {
      gk[g] = sk[t]; gi[g] = si[t];
    }
  }
}

// Sort each B-pair block completely (sizes 2..B).  idx is the global index;
// indices at or past n are padding (EMPTY, idx).
__global__ void sort_blocks(const int* __restrict__ keys, int B, int n,
                            int final_out, int* gk, int* gi, int* ks_out,
                            long long* perm_out) {
  __shared__ int sk[BLOCK];
  __shared__ int si[BLOCK];
  int base = blockIdx.x * B;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    sk[t] = base + t < n ? keys[base + t] : EMPTY_KEY;
    si[t] = base + t;
  }
  __syncthreads();
  smem_stages(sk, si, B, base, 2, B, 1);
  store(sk, si, B, base, n, final_out, gk, gi, ks_out, perm_out);
}

// One global compare-exchange stage (stride >= BLOCK) of bitonic size `size`.
__global__ void global_stage(int* gk, int* gi, int half, int size, int stride) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  int j = i + stride;
  bool asc = (i & size) == 0;
  int ka = gk[i], ia = gi[i], kb = gk[j], ib = gi[j];
  if (pair_gt(ka, ia, kb, ib) == asc) {
    gk[i] = kb; gi[i] = ib; gk[j] = ka; gi[j] = ia;
  }
}

// Finish bitonic size `size` inside each block: strides BLOCK/2 .. 1.
__global__ void finish_blocks(int* gk, int* gi, int size, int n, int final_out,
                              int* ks_out, long long* perm_out) {
  __shared__ int sk[BLOCK];
  __shared__ int si[BLOCK];
  int base = blockIdx.x * BLOCK;
  for (int t = threadIdx.x; t < BLOCK; t += blockDim.x) {
    sk[t] = gk[base + t];
    si[t] = gi[base + t];
  }
  __syncthreads();
  smem_stages(sk, si, BLOCK, base, size, size, BLOCK >> 1);
  store(sk, si, BLOCK, base, n, final_out, gk, gi, ks_out, perm_out);
}

}  // namespace

// The largest n that sorts without scratch: one CTA, no global stages.
extern "C" int chunksort_block() { return BLOCK; }

// keys: int32 [B, n], contiguous, n <= 2048: each row sorted on its own by
// one CTA, in one launch (ks_out int32 and perm_out int64, each [B, n]).
extern "C" int chunksort_sort_rows(const int* keys, int B, int n, int* ks_out,
                                   long long* perm_out, void* stream_ptr) {
  if (B <= 0 || n <= 0) return 0;
  if (n > CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  sort_chunk<<<B, CHUNK_THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      keys, n, ks_out, perm_out);
  return static_cast<int>(cudaGetLastError());
}

// keys: int32 [n], contiguous.  Writes the n sorted keys to ks_out and their
// source indices to perm_out.  scratch_k / scratch_i: int32 [P] each, P the
// power of two at or above n, used only when P > BLOCK.
extern "C" int chunksort_sort_pairs(const int* keys, int n, int* ks_out,
                                    long long* perm_out, int* scratch_k,
                                    int* scratch_i, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return 0;
  if (n <= CHUNK) {
    sort_chunk<<<1, CHUNK_THREADS, 0, stream>>>(keys, n, ks_out, perm_out);
    return static_cast<int>(cudaGetLastError());
  }
  int P = 1;
  while (P < n) P <<= 1;
  if (P <= BLOCK) {
    sort_blocks<<<1, THREADS, 0, stream>>>(keys, P, n, 1, nullptr, nullptr,
                                           ks_out, perm_out);
    return static_cast<int>(cudaGetLastError());
  }
  sort_blocks<<<P / BLOCK, THREADS, 0, stream>>>(keys, BLOCK, n, 0, scratch_k,
                                                 scratch_i, nullptr, nullptr);
  int half = P / 2;
  for (int size = 2 * BLOCK; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride >= BLOCK; stride >>= 1) {
      global_stage<<<(half + 255) / 256, 256, 0, stream>>>(scratch_k, scratch_i,
                                                          half, size, stride);
    }
    finish_blocks<<<P / BLOCK, THREADS, 0, stream>>>(
        scratch_k, scratch_i, size, n, size == P ? 1 : 0, ks_out, perm_out);
  }
  return static_cast<int>(cudaGetLastError());
}
