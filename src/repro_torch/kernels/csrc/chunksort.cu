// Stable chunk sort of int32 keys as a bitonic network over (key, idx) pairs.
//
// Replaces the TPU kernel repro/kernels/chunksort/chunksort.py `sort_pairs`
// (block-local bitonic `_make_block_sort_kernel` + cross-block two-run merges
// `_make_merge_kernel`).  Pairs are compared lexicographically and every idx
// is distinct, so the sorted order IS the stable argsort: the output is
// bit-identical to torch.sort(stable=True) by construction.
//
// Design: one CTA sorts a block of up to BLOCK = 4096 pairs (32 KB) in shared
// memory.  For larger inputs the classic global bitonic sort follows: the
// compare-exchange stages whose stride reaches past a block run as one launch
// each over global memory, and the stages with stride below the block finish
// in shared memory.  The ingest chunk (2048 keys) is a single CTA.
//
// What bounds it on an H100: at the main path's 2048 keys the kernel moves
// 24 KB, far below what launch latency costs, so one launch of one CTA is
// the whole cost; the network's 66 shared-memory stages (each followed by a
// barrier) are the in-kernel critical path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Sort each B-pair block completely (sizes 2..B).  idx is the global index.
__global__ void sort_blocks(const int* __restrict__ keys, int B, int n,
                            int final_out, int* gk, int* gi, int* ks_out,
                            long long* perm_out) {
  __shared__ int sk[BLOCK];
  __shared__ int si[BLOCK];
  int base = blockIdx.x * B;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    sk[t] = keys[base + t];
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

extern "C" int chunksort_block() { return BLOCK; }

// keys: int32 [P], P a power of two (EMPTY-padded by the caller).  Writes the
// first n sorted keys to ks_out and their source indices to perm_out.
// scratch_k / scratch_i: int32 [P] each, used only when P > BLOCK.
extern "C" int chunksort_sort_pairs(const int* keys, int P, int n, int* ks_out,
                                    long long* perm_out, int* scratch_k,
                                    int* scratch_i, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (P <= BLOCK) {
    int threads = P >= 2 * THREADS ? THREADS : (P >= 2 ? P / 2 : 1);
    sort_blocks<<<1, threads, 0, stream>>>(keys, P, n, 1, nullptr, nullptr,
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
