// Blockwise (FlashAttention-style) causal or non-causal GQA attention,
// forward only, for bf16 inputs, on Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// `flash_attention` (`_flash_kernel`) for bfloat16; float32 inputs go to the
// FMA kernel in flash_attention.cu.  It computes what the TPU kernel
// computes: q [B,Hq,S,D] and k, v [B,Hkv,S,D]; q head h reads kv head
// h / (Hq/Hkv); the scores Q.K^T are taken in f32 and scaled by 1/sqrt(D) in
// f32; masked scores are set to NEG_INF = -1e30; the online softmax keeps
// m, l and acc in f32 across kv tiles; the output is acc / l rounded to
// bf16 (round to nearest even).  A ragged S is masked here: kv rows past S
// score NEG_INF and q rows past S are not stored.
//
// What bounds it on an H100: at the serving prefill (B=4, Hq=32, Hkv=4,
// S=4096, D=128, causal) the work is 4*B*Hq*S^2*D/2 = 5.5e11 FLOP, 0.56 ms at
// the 989 TFLOP/s of bf16 tensor cores, against ~300 MB, 0.09 ms at
// 3.35 TB/s: compute bounds it.  So both products run as wgmma on the
// tensor cores, and the copies run beside them.
//
// P in bf16.  A tensor-core P.V needs P in bf16, and one rounding of P
// (8 bits) moves the output by more than the one-ulp gate the callers hold
// bf16 to.  So P is split in registers into P_hi = bf16(p) and
// P_lo = bf16(p - P_hi), and O += P_hi.V + P_lo.V accumulates both in f32:
// P keeps 16 bits, and the products cost 1.5x plain flash attention's MMA
// work (8.25e11 FLOP in place of 5.5e11 at the serving prefill).
//
// Design: one block of 384 threads per (128-row q tile, q head, batch).
// Warpgroup 0 is the producer: it gives up its registers (setmaxnreg, down
// to 24) and one thread of its first warp issues every copy; the other
// three warps only return their registers.  Warpgroups 1 and 2 are
// consumers that own 64 q rows each and take the registers (up to 240).
// * Copies are TMA (cp.async.bulk.tensor) through tensor maps that the host
//   encodes per call from the views' strides (d contiguous), so strided
//   [B,S,H,D] projections are read in place.  The q tile is loaded once;
//   K and V tiles of BK = 128 rows go through a ring of STAGES = 3 slots,
//   each with an mbarrier per tile it fills (full_k, full_v) and one the
//   consumers release it on (empty).  Rows past S come back zero.
// * Tiles sit in shared memory in the swizzled layout (128-byte swizzle at
//   D >= 64, 64 and 32 bytes at D = 32, 16) that TMA writes and wgmma
//   reads: a tile is D/64 column blocks of [rows][64] bf16 at D = 128.
// * S = Q.K^T: wgmma m64n128k16 with both operands in shared memory,
//   K-major (K is stored [BK, D] with D contiguous, so no transpose).
// * The online softmax runs on the f32 accumulator fragments: each thread
//   holds two rows; the row max is taken over the four threads of a row
//   (shuffles), the row sum per thread and over the four threads at the end.
//   exp is exp2 with log2(e) folded into the scale.
// * O += P.V: the S fragment converts in registers into the A fragments of
//   P_hi and P_lo; wgmma m64nDk16 with A in registers and V read from shared
//   memory MN-major (the transpose flag, allowed for 16-bit types).
// * Each consumer runs a software pipeline: the scores of tile j are issued
//   before P.V of tile j - 1, so its softmax runs while the tensor cores take
//   that P.V (S, O and both halves of P live in registers at once: ~215).
//   The third ring slot covers the load of tile j + 1, which can start only
//   once P.V of tile j - 1 has released its slot.
// * q tiles are launched longest first (the q tile is gridDim.z's slowest
//   index, reversed), so the short causal tail fills the card at the end;
//   the heads that share a kv head are neighbours in the launch order, so
//   their K/V tiles are read from L2.
// * The output is acc / l, rounded to bf16 and stored through the caller's
//   strides.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // q rows per block
constexpr int BK = 128;       // kv rows per tile
constexpr int STAGES = 3;     // K/V ring slots
constexpr int CONSUMERS = 2;  // warpgroups of 64 q rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ == 64 * CONSUMERS, "each consumer warpgroup owns 64 q rows");

// Shared-memory layout of a [rows, D] bf16 tile: column blocks of SWIZZLE
// bytes per row, each swizzled as TMA writes it.
template <int D>
struct Tile {
  static constexpr int SWIZZLE = D * 2 >= 128 ? 128 : D * 2;  // bytes per row of a block
  static constexpr int COLS = SWIZZLE / 2;                     // head dims per block
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
  // the matrix descriptor's layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = SWIZZLE == 128 ? 1 : SWIZZLE == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SWIZZLE == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : SWIZZLE == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

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

// Wait for the phase of parity `parity` to complete.  A plain spin: a
// timeout that traps (clock64, __trap) in the consumers' path makes ptxas
// give them fewer registers than setmaxnreg allows and serialize their
// wgmma (flash_variants.py, variant trap_wait).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
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

// ---- wgmma ----------------------------------------------------------------------

// Matrix descriptor of a swizzled tile in shared memory: start address, the
// leading and stride byte offsets (16-byte units) and the layout type.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | Tile<D>::LAYOUT << 62;
}

// K-major operand (Q or K: D contiguous), the 16 head dims from d0: one
// column block holds them; 8-row groups are 8 rows of SWIZZLE bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int d0) {
  using T = Tile<D>;
  const int block = d0 / T::COLS;
  const uint32_t addr = tile + block * rows * T::SWIZZLE + (d0 % T::COLS) * 2;
  return desc<D>(addr, 16, 8 * T::SWIZZLE);
}

// MN-major operand (V as the B of P.V: D contiguous, kv rows the reduction
// dim), the 16 kv rows from r0: column blocks are BK rows apart (the
// leading offset), 8-row groups 8 rows apart (the stride offset).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int r0) {
  using T = Tile<D>;
  return desc<D>(tile + r0 * T::SWIZZLE, BK * T::SWIZZLE, 8 * T::SWIZZLE);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N commit groups still running
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the accumulator registers: no read of them moves above the wait
// before this, and no write of them below the issue after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define F8(i) F4(i), F4((i) + 4)
#define F16(i) F8(i), F8((i) + 8)
#define F32(i) F16(i), F16((i) + 16)
#define F64(i) F32(i), F32((i) + 32)

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) . B (N x 16, shared,
// K-major)^T; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

// d (64 x N, f32) += A (64 x 16, registers) . B (16 x N, shared, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

#undef F4
#undef F8
#undef F16
#undef F32
#undef F64

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ---- the consumer's steps ------------------------------------------------------

// Waits for a ring slot's tile; the warp reconverges after the spin, since
// the wgmma that follow are warp-synchronous.
__device__ __forceinline__ void wait_tile(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// Issues S = Q.K^T of one tile (64 q rows x BK kv rows) as one commit group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint32_t q_rows,
                                             uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BK>(s, desc_k_major<D>(q_rows, BQ, kk * 16), desc_k_major<D>(k_tile, BK, kk * 16),
                 kk > 0);
  wgmma_commit();
}

// Issues O += P_hi.V + P_lo.V of one tile as one commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4], uint32_t v_tile) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, p_hi[kk], desc_mn_major<D>(v_tile, kk * 16));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, p_lo[kk], desc_mn_major<D>(v_tile, kk * 16));
  wgmma_commit();
}

// Where a tile's scores sit: this thread's rows row0 and row0 + 8 hold, in
// each 8-column block, columns col0 and col0 + 1; the warpgroup's rows
// start at wg_row.
struct Rows {
  int row0, col0, wg_row;
};

// Scale, mask and the online softmax of tile j's scores, in the log2
// domain: s becomes p = exp2(x - m), m and l (this thread's share of the row
// sums) move on, and alpha is what rescales the O accumulated so far.
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int j, int n_tiles, int S,
                                             int causal, Rows at, float scale_log2) {
  const int k0 = j * BK;
  int k_end = S;  // kv columns at or past k_end score NEG_INF
  const bool masked = k0 + BK > k_end || (causal && k0 + BK - 1 > at.wg_row);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i] * scale_log2;
    if (masked) {
      const int kpos = k0 + (i / 4) * 8 + at.col0 + (i % 2);
      const int qpos = at.row0 + 8 * ((i / 2) % 2);
      if (kpos >= k_end || (causal && kpos > qpos)) x = NEG_INF;
    }
    s[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = exp2f(s[i] - m[(i / 2) % 2]);
    s[i] = p;
    l[(i / 2) % 2] += p;
  }
}

// P -> the A fragments of P_hi = bf16(p) and P_lo = bf16(p - P_hi).
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x0 = s[8 * kk + 2 * a], x1 = s[8 * kk + 2 * a + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 back = __bfloat1622float2(hi);
      p_hi[kk][a] = bf16x2_bits(hi);
      p_lo[kk][a] = bf16x2_bits(__floats2bfloat162_rn(x0 - back.x, x1 - back.y));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                int group, long long so_b, long long so_h, long long so_s, float scale_log2,
                int causal) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // q_full, then full_k, full_v and empty per ring slot
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];

  const uint32_t q_tile = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto k_tile = [&](int st) { return q_tile + T::Q_BYTES + st * 2 * T::KV_BYTES; };
  auto v_tile = [&](int st) { return k_tile(st) + T::KV_BYTES; };
  auto full_k = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto full_v = [&](int st) { return smem_u32(&bars[1 + STAGES + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + 2 * STAGES + st]); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int n_kv = (S + BK - 1) / BK;
  const int n_tiles = causal ? min(n_kv, (q0 + BQ + BK - 1) / BK) : n_kv;
  // warp-uniform, so that the compiler sees the role branches as non-divergent
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: one thread issues every copy --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(bar_q, T::Q_BYTES);
      for (int c = 0; c < D / T::COLS; ++c)
        tma_load(q_tile + c * BQ * T::SWIZZLE, &tq, bar_q, c * T::COLS, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(empty(st), ((j / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full_k(st), T::KV_BYTES);
        for (int c = 0; c < D / T::COLS; ++c)
          tma_load(k_tile(st) + c * BK * T::SWIZZLE, &tk, full_k(st), c * T::COLS, j * BK, hk, b);
        mbar_expect_tx(full_v(st), T::KV_BYTES);
        for (int c = 0; c < D / T::COLS; ++c)
          tma_load(v_tile(st) + c * BK * T::SWIZZLE, &tv, full_v(st), c * T::COLS, j * BK, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = warpgroup - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = q0 + cw * 64 + (t / 32) * 16 + lane / 4;
    const Rows at{row0, 2 * (lane % 4), q0 + cw * 64};
    const uint32_t q_rows = q_tile + cw * 64 * T::SWIZZLE;
    auto release = [&](int j) {  // this warp is done with tile j's slot
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % STAGES));
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF};  // running row max, log2 domain
    float l[2] = {0.0f, 0.0f};        // this thread's share of the row sum
    float s[BK / 2], alpha[2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    wait_tile(bar_q, 0);

    // Software pipeline: the scores of tile j are issued before P.V of tile
    // j - 1, and its softmax runs while the tensor cores take that P.V.
    wait_tile(full_k(0), 0);
    issue_scores<D>(s, q_rows, k_tile(0));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, alpha, 0, n_tiles, S, causal, at, scale_log2);  // O is 0: alpha unused
    split_p(s, p_hi, p_lo);
    for (int j = 1; j < n_tiles; ++j) {
      wait_tile(full_k(j % STAGES), (j / STAGES) & 1);
      issue_scores<D>(s, q_rows, k_tile(j % STAGES));
      wait_tile(full_v((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
      issue_pv<D>(acc, p_hi, p_lo, v_tile((j - 1) % STAGES));
      wgmma_wait<1>();  // the scores are done; P.V of tile j - 1 runs on
      fence_regs(s);
      softmax_tile(s, m, l, alpha, j, n_tiles, S, causal, at, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(s);  // P_hi, P_lo of tile j - 1 are free only now
      release(j - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      split_p(s, p_hi, p_lo);
    }
    wait_tile(full_v((n_tiles - 1) % STAGES), ((n_tiles - 1) / STAGES) & 1);
    issue_pv<D>(acc, p_hi, p_lo, v_tile((n_tiles - 1) % STAGES));
    wgmma_wait<0>();
    fence_regs(acc);
    release(n_tiles - 1);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* ob = o + b * so_b + h * so_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float o0 = acc[4 * c + 2 * r], o1 = acc[4 * c + 2 * r + 1];
        *reinterpret_cast<__nv_bfloat162*>(ob + row * so_s + 8 * c + at.col0) =
            __floats2bfloat162_rn(o0 / l[r], o1 / l[r]);
      }
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

// The tensor map of a [B, H, S, D] bf16 view with element strides st = (b, h,
// s) and d contiguous; boxes of [rows, COLS] are the tiles' column blocks.  A
// dim of extent 1 is never stepped, so its stride is replaced by 16 bytes.
template <int D>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int S,
            const long long* st, int rows) {
  auto bytes = [](long long stride, int n) {
    return static_cast<cuuint64_t>(n == 1 ? 16 : stride * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st[2], S), bytes(st[1], H), bytes(st[0], B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::COLS),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
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
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + BQ - 1) / BQ);
  flash_tc_kernel<D><<<grid, THREADS, Tile<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq / Hkv, st[9], st[10], st[11],
      scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order; d is
// contiguous in all four, and q, k, v start and step (where their extent is
// above 1) on 16-byte boundaries, as TMA needs.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
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
