// Blockwise (FlashAttention-style) causal or non-causal GQA attention,
// forward only, for f32 inputs, on Hopper's tensor cores in 3xTF32.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// `flash_attention` (`_flash_kernel`) for float32; bfloat16 inputs go to the
// tensor-core kernel in flash_attention_sm90.cu.  It computes what the FMA
// kernel flash_attention.cu computed on this route before: q [B,Hq,S,D] and
// k, v [B,Hkv,S,D]; q head h reads kv head h / (Hq/Hkv); q is scaled by
// 1/sqrt(D) before QK^T; masked scores are set to NEG_INF = -1e30; the online
// softmax keeps m, l and acc in f32 across kv tiles; the output is acc / l.
// A ragged S is masked here: kv rows past S score NEG_INF and q rows past S
// are not stored.
//
// 3xTF32.  One TF32 product keeps 11 bits of each operand, which moves the
// output by ~1e-2, far past the 2e-5 the callers hold f32 to.  So every
// operand x is split into hi = tf32(x) (cvt.rna: round to nearest) and
// lo = tf32(x - hi) (x - hi is exact), and a.b ~ a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, accumulated in f32 in that order (small terms first); only
// a_lo.b_lo (2^-22 of a.b) and the rounding of lo are lost, ~21-22 bits of
// each product.  Both products, S = Q.K^T and O += P.V, run so.
//
// What bounds it on an H100: at the serving prefill (B=4, Hq=32, Hkv=4,
// S=4096, D=128, causal) attention is 4*B*Hq*S^2*D/2 = 5.5e11 FLOP; three
// TF32 products of it take 1.65e12 FLOP, 3.33 ms at the 495 TFLOP/s of TF32
// tensor cores (the FMA units' bound for the f32 work is 8.21 ms at 67
// TFLOP/s), against ~600 MB, 0.18 ms at 3.35 TB/s: compute bounds it.
//
// Design: one block of 384 threads per (128-row q tile, q head, batch).
// * Warpgroup 0 is the producer and the converter (setmaxnreg down to 56).
//   Thread 0 issues the TMA copies (cp.async.bulk.tensor through tensor maps
//   encoded per call from the views' strides, d contiguous, so strided
//   [B,S,H,D] projections are read in place; rows past S come back zero).
//   All 128 threads split each K/V tile once for both consumers: K in place
//   (the raw tile TMA wrote becomes K_hi, K_lo goes beside it, elementwise,
//   so the swizzle needs no thought), V transposed into Vt_hi and Vt_lo.
// * TF32 wgmma takes its B operand K-major only.  K [keys, D] with D
//   contiguous is K-major for S = Q.K^T as TMA lands it.  V [keys, D] is
//   MN-major for P.V, and TMA does not transpose 32-bit data, so the
//   converter writes V^T [D, keys] (keys contiguous, 128-byte swizzle).  The
//   operands are not swapped (O^T = V^T.P^T would need M = D >= 64 and P in
//   shared memory).
// * P goes from the scores' accumulator straight into the A registers of the
//   tf32 k=8 wgmma.  A thread holds keys 2t, 2t+1 of each 8-key group of the
//   accumulator but the A fragment wants keys t, t+4; so P enters A as it
//   lies, and the converter stores V^T's keys in the matching order (key j
//   of a group at position j/2 + 4 (j%2)).  Nothing moves through shared
//   memory for it.
// * Shared memory at D = 128 (227 KB is the most a block may have): the q
//   tile, 64 KB, becomes Q_lo in place; Q_hi lives in the consumers'
//   registers (64 of them), since both terms that use it then read A from
//   registers.  Kv tiles are 32 rows; each of the 2 ring slots holds K_hi
//   (the raw tile), K_lo, Vt_hi, Vt_lo and the raw V tile, 16 KB each:
//   64 + 2 * 80 = 224 KB.  Two slots let the split of tile j + 1 run while
//   the consumers take tile j.
// * Warpgroups 1 and 2 are consumers that own 64 q rows each (setmaxnreg up
//   to 224).  Per tile: S = Q_lo.K_hi (A from shared memory) + Q_hi.K_lo +
//   Q_hi.K_hi (A from registers), wgmma m64n32k8, one commit group; the
//   online softmax on the accumulator fragments (each thread two rows, the
//   row max over the four threads of a row by shuffles, expf as the FMA
//   kernel); P split in registers; O += P_lo.Vt_hi + P_hi.Vt_lo +
//   P_hi.Vt_hi, wgmma m64nDk8.  The two consumers interleave on the tensor
//   cores: one's softmax runs while the other's products do.
// * q tiles are launched longest first; heads that share a kv head are
//   neighbours in the launch order, so their K/V tiles come from L2.
// * The output is acc / l, stored through the caller's strides.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // q rows per block
constexpr int BK = 32;        // kv rows per tile: one 128-byte row of V^T
constexpr int SLOTS = 2;      // K/V ring slots
constexpr int CONSUMERS = 2;  // warpgroups of 64 q rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr float NEG_INF = -1e30f;

static_assert(BQ == 64 * CONSUMERS, "each consumer warpgroup owns 64 q rows");
static_assert(BK * 4 == 128, "a row of V^T is one 128-byte swizzle row");

// Shared-memory layout of a [rows, D] f32 tile (q, K, raw V) as TMA writes
// it: column blocks of SWIZZLE bytes per row.
template <int D>
struct Tile {
  static constexpr int SWIZZLE = D * 4 >= 128 ? 128 : D * 4;  // bytes per row of a block
  static constexpr int COLS = SWIZZLE / 4;                     // head dims per block
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int KV_BYTES = BK * D * 4;  // K_hi, K_lo, Vt_hi, Vt_lo and raw V alike
  static constexpr int SLOT_BYTES = 5 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + SLOTS * SLOT_BYTES + 1024;  // + alignment slack
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SWIZZLE == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : SWIZZLE == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte offset at which a W-byte swizzle (as TMA writes it and wgmma
// reads it) puts the byte at `o` of a tile with rows of W bytes: the 16-byte
// chunk index is XORed with the row's bits above it.
template <int W>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & (W / 16 - 1)) << 4);
}

// Offset of element (r, c) of a [rows, D] tile in column blocks.
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int c) {
  using T = Tile<D>;
  return (c / T::COLS) * rows * T::SWIZZLE + swz<T::SWIZZLE>(r * T::SWIZZLE + (c % T::COLS) * 4);
}

__device__ __forceinline__ float lds(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a) : "memory");
  return x;
}
__device__ __forceinline__ void sts(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
}
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a)
               : "memory");
  return x;
}
__device__ __forceinline__ void sts4(uint32_t a, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(a), "r"(x.x), "r"(x.y),
               "r"(x.z), "r"(x.w)
               : "memory");
}

// ---- the split ----------------------------------------------------------------

// tf32(x), rounded to nearest (ties away from zero), as its f32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x); lo = tf32(x - hi), x - hi being exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---- mbarriers, named barriers, fences ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete (a plain spin, as in
// flash_attention_sm90.cu).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// This warp's generic-proxy writes of shared memory, made visible to the
// async proxy (wgmma) before the barrier that hands them over.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA ----------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h), "r"(b)
      : "memory");
}

// ---- wgmma (tf32) ---------------------------------------------------------------

// Matrix descriptor of a K-major tile with rows of W bytes, swizzled W
// bytes wide: start address, leading offset 16 bytes (unused when the 32
// bytes of one k-step lie inside a row), 8-row groups 8 rows apart.
template <int W>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t layout = W == 128 ? 1 : W == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>((8 * W) >> 4) << 32 | layout << 62;
}

// k-step kk (head dims 8kk .. 8kk+7) of a [rows, D] tile in column blocks
// (q or K: D contiguous, K-major for S = Q.K^T)
template <int D>
__device__ __forceinline__ uint64_t desc_dims(uint32_t tile, int rows, int kk) {
  using T = Tile<D>;
  const int d0 = kk * 8;
  return desc<T::SWIZZLE>(tile + (d0 / T::COLS) * rows * T::SWIZZLE + (d0 % T::COLS) * 4);
}

// k-step kk (key positions 8kk .. 8kk+7) of a [D, BK] V^T tile
__device__ __forceinline__ uint64_t desc_keys(uint32_t vt, int kk) {
  return desc<128>(vt + kk * 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins registers: no read of them moves above the wait before this, and no
// write of them (or reuse of the registers) below the issue before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define F8(i) F4(i), F4((i) + 4)
#define F16(i) F8(i), F8((i) + 8)
#define F32(i) F16(i), F16((i) + 16)
#define F64(i) F32(i), F32((i) + 32)

// d (64 x 32, f32) (+)= A (64 x 8, shared, K-major) . B (32 x 8, shared,
// K-major)^T; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : F16(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 8, registers) . B (N x 8, shared, K-major)^T
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F4
#undef F8
#undef F16
#undef F32
#undef F64

// d (64 x N) += A (registers) . B (shared)^T, N = 16, 32, 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---- the converter's steps -----------------------------------------------------

// K in place: the raw tile becomes K_hi, and K_lo goes to the same offsets
// of its own tile (elementwise, so the swizzle does not matter).
template <int D>
__device__ __forceinline__ void split_k(uint32_t k_hi, uint32_t k_lo, int t) {
  for (int i = t; i < Tile<D>::KV_BYTES / 16; i += 128) {
    const float4 x = lds4(k_hi + 16 * i);
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    sts4(k_hi + 16 * i, hi);
    sts4(k_lo + 16 * i, lo);
  }
}

// V [BK, D] (raw, as TMA wrote it) -> V^T_hi, V^T_lo [D, BK]: row d holds
// the tile's keys, key j of each group of 8 at position j/2 + 4 (j%2) (the
// order in which P's accumulator fragments enter the A registers).  A
// thread takes one (d, group): 8 reads down a column of the raw tile, two
// 16-byte writes to each of V^T_hi and V^T_lo.
template <int D>
__device__ __forceinline__ void split_v(uint32_t raw, uint32_t vt_hi, uint32_t vt_lo, int t) {
  for (int idx = t; idx < D * (BK / 8); idx += 128) {
    const int d = idx % D, g = idx / D;
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) split(lds(raw + tile_offset<D>(BK, 8 * g + j, d)), hi[j], lo[j]);
    // positions 8g .. 8g+3: keys 0, 2, 4, 6 of the group; 8g+4 .. 8g+7: 1, 3, 5, 7
    const uint32_t even = swz<128>(d * 128 + (2 * g) * 16);
    const uint32_t odd = swz<128>(d * 128 + (2 * g + 1) * 16);
    sts4(vt_hi + even, make_uint4(hi[0], hi[2], hi[4], hi[6]));
    sts4(vt_hi + odd, make_uint4(hi[1], hi[3], hi[5], hi[7]));
    sts4(vt_lo + even, make_uint4(lo[0], lo[2], lo[4], lo[6]));
    sts4(vt_lo + odd, make_uint4(lo[1], lo[3], lo[5], lo[7]));
  }
}

// ---- the consumer's steps ------------------------------------------------------

// Waits for a ring slot's tile; the warp reconverges after the spin, since
// the wgmma that follow are warp-synchronous.
__device__ __forceinline__ void wait_tile(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// Where a tile's scores sit: this thread's rows row0 and row0 + 8 hold, in
// each 8-column block, columns col0 and col0 + 1; the warpgroup's rows
// start at wg_row.
struct Rows {
  int row0, col0, wg_row;
};

// Mask and the online softmax of tile j's scores: s becomes p = exp(x - m),
// m and l (this thread's share of the row sums) move on, and alpha is what
// rescales the O accumulated so far.
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int j, int S, int causal,
                                             Rows at) {
  const int k0 = j * BK;
  const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > at.wg_row);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i];
    if (masked) {
      const int kpos = k0 + (i / 4) * 8 + at.col0 + (i % 2);
      const int qpos = at.row0 + 8 * ((i / 2) % 2);
      if (kpos >= S || (causal && kpos > qpos)) x = NEG_INF;
    }
    s[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = expf(s[i] - m[(i / 2) % 2]);
    s[i] = p;
    l[(i / 2) % 2] += p;
  }
}

// P -> the A fragments of P_hi and P_lo for k-steps of 8 keys.  The A
// fragment of a tf32 k=8 wgmma gives this thread (row, k) = (r, t), (r+8,
// t), (r, t+4), (r+8, t+4); the accumulator gave it keys 2t, 2t+1 of rows r
// and r + 8.  So k = t carries key 2t and k = t + 4 key 2t + 1, the order
// in which split_v stores V^T's keys.
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], uint32_t (&p_hi)[BK / 8][4],
                                        uint32_t (&p_lo)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    split(s[4 * kk + 0], p_hi[kk][0], p_lo[kk][0]);  // (r, 2t)
    split(s[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);  // (r + 8, 2t)
    split(s[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);  // (r, 2t + 1)
    split(s[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);  // (r + 8, 2t + 1)
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int S,
                  int group, long long so_b, long long so_h, long long so_s, float scale,
                  int causal) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // q_full, then k_full, v_full, split (the tile is converted) and empty
  // per ring slot
  __shared__ __align__(8) uint64_t bars[1 + 4 * SLOTS];

  const uint32_t q_tile = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto slot = [&](int st) { return q_tile + T::Q_BYTES + st * T::SLOT_BYTES; };
  auto k_hi = [&](int st) { return slot(st); };
  auto k_lo = [&](int st) { return slot(st) + T::KV_BYTES; };
  auto vt_hi = [&](int st) { return slot(st) + 2 * T::KV_BYTES; };
  auto vt_lo = [&](int st) { return slot(st) + 3 * T::KV_BYTES; };
  auto v_raw = [&](int st) { return slot(st) + 4 * T::KV_BYTES; };
  auto k_full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto v_full = [&](int st) { return smem_u32(&bars[1 + SLOTS + st]); };
  auto split_done = [&](int st) { return smem_u32(&bars[1 + 2 * SLOTS + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + 3 * SLOTS + st]); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int n_kv = (S + BK - 1) / BK;
  const int n_tiles = causal ? min(n_kv, (q0 + BQ + BK - 1) / BK) : n_kv;
  // warp-uniform, so that the compiler sees the role branches as non-divergent
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < SLOTS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(split_done(st), 4);        // one arrival per converter warp
      mbar_init(empty(st), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer and converter ------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    const int t = threadIdx.x;
    const int hk = h / group;
    if (t == 0) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
      for (int c = 0; c < D / T::COLS; ++c)
        tma_load(q_tile + c * BQ * T::SWIZZLE, &tq, bar_q, c * T::COLS, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % SLOTS;
      const uint32_t ph = (j / SLOTS) & 1;
      if (t == 0) {
        // the consumers are done with tile j - SLOTS (the first round passes
        // at once); its raw V was read before its split was signalled
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), T::KV_BYTES);
        for (int c = 0; c < D / T::COLS; ++c)
          tma_load(k_hi(st) + c * BK * T::SWIZZLE, &tk, k_full(st), c * T::COLS, j * BK, hk, b);
        mbar_expect_tx(v_full(st), T::KV_BYTES);
        for (int c = 0; c < D / T::COLS; ++c)
          tma_load(v_raw(st) + c * BK * T::SWIZZLE, &tv, v_full(st), c * T::COLS, j * BK, hk, b);
      }
      mbar_wait(k_full(st), ph);
      split_k<D>(k_hi(st), k_lo(st), t);
      mbar_wait(v_full(st), ph);
      split_v<D>(v_raw(st), vt_hi(st), vt_lo(st), t);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(split_done(st));
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int cw = warpgroup - 1;
    const int t = threadIdx.x % 128;
    const int r_local = cw * 64 + (t / 32) * 16 + lane / 4;  // this thread's first row in the tile
    const int row0 = q0 + r_local;
    const Rows at{row0, 2 * (lane % 4), q0 + cw * 64};
    const uint32_t q_lo = q_tile + cw * 64 * T::SWIZZLE;  // this warpgroup's rows of Q_lo

    // Q * scale split: Q_hi into this thread's A fragments, Q_lo in place.
    // The A fragments of the warpgroup cover each of its 64 x D elements once.
    uint32_t q_hi[D / 8][4];
    wait_tile(bar_q, 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint32_t addr =
            q_tile + tile_offset<D>(BQ, r_local + 8 * (a & 1), 8 * kk + lane % 4 + 4 * (a >> 1));
        uint32_t lo;
        split(lds(addr) * scale, q_hi[kk][a], lo);
        sts(addr, lo);
      }
    }
    fence_async_smem();
    named_sync(1 + cw, 128);  // all of Q_lo is written before any wgmma reads it

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF};  // running row max
    float l[2] = {0.0f, 0.0f};        // this thread's share of the row sum
    float s[BK / 2], alpha[2];
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % SLOTS;
      wait_tile(split_done(st), (j / SLOTS) & 1);
      // S = Q_lo.K_hi + Q_hi.K_lo + Q_hi.K_hi, small terms first
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_ss_n32(s, desc_dims<D>(q_lo, BQ, kk), desc_dims<D>(k_hi(st), BK, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_rs_n32(s, q_hi[kk], desc_dims<D>(k_lo(st), BK, kk));
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_rs_n32(s, q_hi[kk], desc_dims<D>(k_hi(st), BK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, j, S, causal, at);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      split_p(s, p_hi, p_lo);
      // O += P_lo.V_hi + P_hi.V_lo + P_hi.V_hi
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) wgmma_rs<D>(acc, p_lo[kk], desc_keys(vt_hi(st), kk));
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) wgmma_rs<D>(acc, p_hi[kk], desc_keys(vt_lo(st), kk));
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) wgmma_rs<D>(acc, p_hi[kk], desc_keys(vt_hi(st), kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);  // the A registers are free only now
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the slot
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float* ob = o + b * so_b + h * so_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(ob + row * so_s + 8 * c + at.col0) =
            make_float2(acc[4 * c + 2 * r] / l[r], acc[4 * c + 2 * r + 1] / l[r]);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [B, H, S, D] f32 view with element strides st = (b, h,
// s) and d contiguous; boxes of [rows, COLS] are the tiles' column blocks.  A
// dim of extent 1 is never stepped, so its stride is replaced by 16 bytes.
template <int D>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int S,
            const long long* st, int rows) {
  auto bytes = [](long long stride, int n) {
    return static_cast<cuuint64_t>(n == 1 ? 16 : stride * 4);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st[2], S), bytes(st[1], H), bytes(st[0], B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::COLS),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<D>::TMA_SWIZZLE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int S, const long long* st, float scale, int causal, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(enc, &tq, q, B, Hq, S, st, BQ) || !encode<D>(enc, &tk, k, B, Hkv, S, st + 3, BK) ||
      !encode<D>(enc, &tv, v, B, Hkv, S, st + 6, BK))
    return cudaErrorInvalidValue;
  // the attribute belongs to the current device, so it is set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + BQ - 1) / BQ);
  flash_tf32_kernel<D><<<grid, THREADS, Tile<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), S, Hq / Hkv, st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order; d is
// contiguous in all four, and q, k, v start and step (where their extent is
// above 1) on 16-byte boundaries, as TMA needs.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int flash_attention_tf32_launch(const void* q, const void* k, const void* v, void* o,
                                           int B, int Hq, int Hkv, int S, int D,
                                           const long long* strides, float scale, int causal,
                                           void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B > 65535 ||
      (S + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Hq, Hkv, S, strides, scale, causal, st);
    case 32: return launch<32>(q, k, v, o, B, Hq, Hkv, S, strides, scale, causal, st);
    case 64: return launch<64>(q, k, v, o, B, Hq, Hkv, S, strides, scale, causal, st);
    case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, S, strides, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
