// Fused multi-lane scoring + per-key reduction of a key-sorted stream chunk.
//
// Replaces the TPU kernel repro/kernels/capscore/capscore.py `capscore_agg`
// (`_make_capscore_agg_kernel`).  For every l lane it scores each element of
// the key-sorted chunk (two uint32 avalanche hashes -> u, e = -log1p(-u),
// KeyBase, score, Delta, entry gate; paper eq. 10 and Algorithm 4) and
// reduces per key: w_total, entered, contrib (weight from the first entry
// onward, the first entry counting w - Delta), kb_min and min_score.
//
// What bounds it on an H100: at the main path's C = 2048, L = 4 it reads
// 16 B per element and writes (4 + 13 L) B per row, about 140 KB in all,
// well under a microsecond of memory time.  What costs is the launch, one
// SM's issue of the arithmetic (two hashes, log1pf and 2 L + 1 IEEE
// divisions per element), the CTA's critical path through loads, scans and
// barriers, and the stores of the rows.
//
// Design: one CTA of 512 threads reduces the chunk, four consecutive
// elements per thread in registers (a 2048-element tile; larger chunks loop
// over tiles inside the CTA, the TPU kernel's sequential grid carry).  Each
// element is hashed once, and scored once per lane in groups of G = 4
// lanes.  Segment heads are seg[i] != seg[i-1].  Every per-key column is
// then one segmented inclusive scan over the tile of the monoid
//     (flags: head seen | entered per lane, w, contrib per lane, min per lane)
// in which a span "a then b" with no head in b gives
//     entered = a.e | b.e,  w = a.w + b.w,
//     contrib = a.e ? a.contrib + b.w : b.contrib,  min = fminf(a.m, b.m),
// the TPU kernel's carry `ctr = prev_ent ? prev_ctr + bw : bc` written as an
// associative operator; a span with a head in b is b.  An element starts as
// (head, es, w·live, es ? w - Delta : 0, live ? score : inf).  The scan runs
// in each thread's registers, then up the warp by shuffles, then across the
// sixteen warps through shared memory (warp 0 scans the warp totals, with
// the previous tile's carry in front), then back down each thread's
// elements.  The last element of each segment stages row seg[i] in shared
// memory (kb_min is the segment's one KeyBase, or +inf for the EMPTY
// segment), and the tile's rows then leave in coalesced stores (written
// straight from the segment ends, a warp's stores scatter over many lines).
// Rows no segment owns get the reduction identities: those past the last
// segment id from up to 16 helper CTAs, so that one SM does not write them
// all.  kernel_variants.py times each of these choices against its
// alternative.  No binary search, no per-key walk, no atomics: the scan
// order is fixed, so two launches give the same bits.
//
// A batch of B chunks (the multi-tenant bank's tick: one chunk per tenant,
// each with its own salt and taus, the l grid shared) is one launch on a
// grid of (B, 1 + helpers): CTA (b, 0) reduces chunk b exactly as a
// single-chunk launch does, CTAs (b, y > 0) write its identity rows, and
// every output gains a leading [B].
//
// Exactness: entered, kb_min and min_score equal the plain PyTorch version
// bit for bit (same IEEE divisions in the same order — ku / l, not
// ku * (1/l) — and the same libdevice log1pf PyTorch's CUDA log1p calls;
// build without --use_fast_math).  w_total and contrib are f32 sums taken in
// another order than the plain version's scatter-add.
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
constexpr int THREADS = 512;
constexpr int ITEMS = 4;                  // consecutive elements per thread, a multiple of 4
constexpr int TILE = THREADS * ITEMS;     // 2048: the ingest chunk
constexpr int WARPS = THREADS / 32;
constexpr int G = 4;                      // lanes scored per scan
constexpr int MAX_LANES = 4096;           // carries of the lane groups: 40 KB
constexpr int MAX_HELPERS = 16;           // CTAs that write the identity rows
constexpr unsigned HEAD = 0x80000000u;    // flags bit: a segment head in the span
constexpr unsigned FULL = 0xffffffffu;

// A span's segmented aggregate, from its last segment head to its end.
struct Agg {
  unsigned flags;  // HEAD | bit j: lane j entered in the span
  float w;         // live weight
  float c[G];      // contrib, were the segment not entered before the span
  float m[G];      // min score
};

__device__ __forceinline__ Agg identity() {
  Agg a;
  a.flags = 0u;
  a.w = 0.0f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    a.c[j] = 0.0f;
    a.m[j] = INFINITY;
  }
  return a;
}

// a then b
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  if (b.flags & HEAD) return b;
  Agg r;
  r.flags = a.flags | b.flags;
  r.w = a.w + b.w;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    r.c[j] = ((a.flags >> j) & 1u) ? a.c[j] + b.w : b.c[j];
    r.m[j] = fminf(a.m[j], b.m[j]);
  }
  return r;
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int d) {
  Agg r;
  r.flags = __shfl_up_sync(FULL, a.flags, d);
  r.w = __shfl_up_sync(FULL, a.w, d);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    r.c[j] = __shfl_up_sync(FULL, a.c[j], d);
    r.m[j] = __shfl_up_sync(FULL, a.m[j], d);
  }
  return r;
}

// inclusive scan over the warp's lanes
__device__ __forceinline__ Agg warp_scan(Agg x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Agg o = shfl_up(x, d);
    if (lane >= d) x = combine(o, x);
  }
  return x;
}

template <typename T> __device__ __forceinline__ T from_bits(int x);
template <> __device__ __forceinline__ int from_bits<int>(int x) { return x; }
template <> __device__ __forceinline__ float from_bits<float>(int x) { return __int_as_float(x); }

template <typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ p, int first,
                                           int C, bool vec, T (&out)[ITEMS]) {
  if (vec && first + ITEMS <= C) {
    // ITEMS / 4 16-byte loads (first is a multiple of ITEMS)
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p + first) + q);
      out[4 * q] = from_bits<T>(a.x);
      out[4 * q + 1] = from_bits<T>(a.y);
      out[4 * q + 2] = from_bits<T>(a.z);
      out[4 * q + 3] = from_bits<T>(a.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) out[k] = first + k < C ? p[first + k] : T(0);
  }
}

struct Out {
  float* w_total;
  uint8_t* entered;
  float* contrib;
  float* kb_min;
  float* min_score;
  int C, L;
};

// row r owned by no segment: the reduction identities
__device__ __forceinline__ void identity_row(const Out& o, int r) {
  o.w_total[r] = 0.0f;
  for (int j = 0; j < o.L; ++j) {
    const size_t i = static_cast<size_t>(j) * o.C + r;
    o.entered[i] = 0;
    o.contrib[i] = 0.0f;
    o.kb_min[i] = INFINITY;
    o.min_score[i] = INFINITY;
  }
}

// One lane group's output rows of a tile, staged in shared memory so that
// they leave in coalesced stores: row A + i of the tile at index i.
struct Stage {
  float w[TILE];
  float c[G][TILE];
  float kb[G][TILE];
  float m[G][TILE];
  uint8_t e[G][TILE];
};
constexpr int STAGE_BYTES = static_cast<int>(sizeof(Stage));

// row r (lanes j0 .. j0 + G - 1) into the stage; rows outside the tile's
// window (only from a seg that is not dense, which the contract excludes)
// are dropped rather than written past it
__device__ __forceinline__ void stage_row(Stage& st, int r, int A, int g,
                                          const Agg& a, const float (&kb)[G]) {
  const unsigned i = static_cast<unsigned>(r - A);
  if (i >= static_cast<unsigned>(TILE)) return;
  if (g == 0) st.w[i] = a.w;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    st.e[j][i] = (a.flags >> j) & 1u;
    st.c[j][i] = a.c[j];
    st.kb[j][i] = kb[j];
    st.m[j][i] = a.m[j];
  }
}

// Chunk b = blockIdx.x of the batch: its rows of ks, eids, ws, seg, taus and
// of every output; its salt is salts[b], or `salt` when salts is null.
__global__ void __launch_bounds__(THREADS)
capscore_agg_kernel(const int* __restrict__ ks, const int* __restrict__ eids,
                    const float* __restrict__ ws, const int* __restrict__ seg,
                    int C, const float* __restrict__ ls,
                    const float* __restrict__ taus, int L,
                    const uint32_t* __restrict__ salts, uint32_t salt, Out o) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  {
    const size_t b = blockIdx.x;
    ks += b * C;
    eids += b * C;
    ws += b * C;
    seg += b * C;
    taus += b * L;
    o.w_total += b * C;
    o.entered += b * L * C;
    o.contrib += b * L * C;
    o.kb_min += b * L * C;
    o.min_score += b * L * C;
    if (salts != nullptr) salt = salts[b];
  }
  if (blockIdx.y > 0) {
    // the helper CTAs: rows past the last segment id get the identities
    const int helpers = gridDim.y - 1;
    for (int r = max(seg[C - 1] + 1, 0) + (blockIdx.y - 1) * THREADS + t; r < C;
         r += helpers * THREADS)
      identity_row(o, r);
    return;
  }
  extern __shared__ __align__(16) unsigned char dyn[];
  Stage& st = *reinterpret_cast<Stage*>(dyn);
  __shared__ Agg carry[MAX_LANES / G];  // per lane group, across tiles
  __shared__ Agg warp_prefix[WARPS];
  const int groups = (L + G - 1) / G;
  const bool vec = ((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(eids) |
                     reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(seg)) &
                    15) == 0;
  for (int g = t; g < groups; g += THREADS) carry[g] = identity();
  __syncthreads();

  for (int t0 = 0; t0 < C; t0 += TILE) {
    const int t1 = min(t0 + TILE, C);
    // the tile's rows [A, B): the segments that end in it
    const int A = seg[t0];
    const int B = t1 == C || seg[t1] != seg[t1 - 1] ? seg[t1 - 1] + 1 : seg[t1 - 1];
    const int first = t0 + t * ITEMS;
    int key[ITEMS], eid[ITEMS], s[ITEMS];
    float w[ITEMS];
    load_items(ks, first, C, vec, key);
    load_items(eids, first, C, vec, eid);
    load_items(ws, first, C, vec, w);
    load_items(seg, first, C, vec, s);
    const int s_before = first > 0 && first < C ? seg[first - 1] : -1;
    const int s_after = first + ITEMS < C ? seg[first + ITEMS] : -1;

    // the element's hashes once, for every lane group
    float e[ITEMS] = {}, v[ITEMS] = {}, ku[ITEMS] = {};
    unsigned live = 0u, head = 0u, end = 0u;  // bit k: element k
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = first + k;
      if (i >= C) continue;
      const float u = u01(hash3(static_cast<uint32_t>(eid[k]), SALT_ELEM, salt));
      e[k] = -log1pf(-u);
      v[k] = e[k] / w[k];
      ku[k] = u01(hash3(static_cast<uint32_t>(key[k]), SALT_KEYBASE, salt));
      live |= static_cast<unsigned>(key[k] != EMPTY_KEY) << k;
      const int prev = k > 0 ? s[k - 1] : s_before;
      const int next = k + 1 < ITEMS ? s[k + 1] : s_after;
      if (i == 0 || s[k] != prev) head |= 1u << k;
      if (i == C - 1 || s[k] != next) end |= 1u << k;
    }

    for (int g = 0; g < groups; ++g) {
      const int j0 = g * G;
      float l[G], inv_l[G], rate[G], tau[G];
      bool always[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const bool on = j0 + j < L;
        l[j] = on ? ls[j0 + j] : 1.0f;
        tau[j] = on ? taus[j0 + j] : 0.0f;
        inv_l[j] = 1.0f / l[j];
        rate[j] = fmaxf(inv_l[j], tau[j]);
        always[j] = tau[j] * l[j] > 1.0f;
      }
      Agg item[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        item[k] = identity();
        if (first + k >= C) continue;
        const bool lv = (live >> k) & 1u;
        item[k].flags = ((head >> k) & 1u) ? HEAD : 0u;
        item[k].w = lv ? w[k] : 0.0f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float kb = ku[k] / l[j];  // division, as the plain version
          const float score = v[k] <= inv_l[j] ? kb : v[k];
          const float delta = e[k] / rate[j];
          const bool es = lv && delta < w[k] && (always[j] || kb < tau[j]);
          item[k].flags |= static_cast<unsigned>(es) << j;
          item[k].c[j] = es ? w[k] - delta : 0.0f;
          item[k].m[j] = lv ? score : INFINITY;
        }
      }
      // up: the thread's span, the warp's inclusive scan, the warp totals
      Agg span = item[0];
#pragma unroll
      for (int k = 1; k < ITEMS; ++k) span = combine(span, item[k]);
      const Agg incl = warp_scan(span, lane);
      Agg before = shfl_up(incl, 1);
      if (lane == 0) before = identity();
      if (lane == 31) warp_prefix[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const Agg in = carry[g];
        Agg y = lane < WARPS ? warp_prefix[lane] : identity();
        if (lane == 0) y = combine(in, y);
        y = warp_scan(y, lane);
        Agg ex = shfl_up(y, 1);
        if (lane == 0) ex = in;
        __syncwarp();
        if (lane < WARPS) warp_prefix[lane] = ex;
        if (lane == WARPS - 1) carry[g] = y;
      }
      __syncthreads();
      // down: each element's inclusive aggregate; segment ends stage their rows
      Agg run = combine(warp_prefix[warp], before);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        run = combine(run, item[k]);
        if (!((end >> k) & 1u)) continue;
        const bool lv = (live >> k) & 1u;
        float kb[G];
#pragma unroll
        for (int j = 0; j < G; ++j) kb[j] = lv ? ku[k] / l[j] : INFINITY;
        stage_row(st, s[k], A, g, run, kb);
      }
      __syncthreads();
      // the staged rows leave in coalesced stores
      const int rows = min(min(B, C) - A, TILE);  // a dense seg: B - A <= TILE
      for (int i = t; i < rows; i += THREADS) {
        const int r = A + i;
        if (g == 0) o.w_total[r] = st.w[i];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j0 + j >= L) break;
          const size_t x = static_cast<size_t>(j0 + j) * C + r;
          o.entered[x] = st.e[j][i];
          o.contrib[x] = st.c[j][i];
          o.kb_min[x] = st.kb[j][i];
          o.min_score[x] = st.m[j][i];
        }
      }
      __syncthreads();  // the stage and warp_prefix are rewritten next
    }
  }
}

}  // namespace

// ks, eids, seg: int32 [C]; ws: f32 [C] (the key-sorted chunk view; seg its
// dense segment ids 0 .. n_seg - 1, as segments.segment_ids makes them: a
// row that a seg with gaps leaves to no segment is left undefined);
// ls, taus: f32 [L] on the device, 1 <= L <= 4096.  Outputs:
// w_total f32 [C]; entered u8, contrib, kb_min, min_score f32, each [L, C]
// row-major.
namespace {

int launch(const int* ks, const int* eids, const float* ws, const int* seg,
           int B, int C, const float* ls, const float* taus, int L,
           const uint32_t* salts, uint32_t salt, float* w_total,
           unsigned char* entered, float* contrib, float* kb_min,
           float* min_score, void* stream_ptr) {
  if (B < 1 || C < 1 || L < 1 || L > MAX_LANES)
    return static_cast<int>(cudaErrorInvalidValue);
  static cudaError_t attr = cudaFuncSetAttribute(
      capscore_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Out o{w_total, entered, contrib, kb_min, min_score, C, L};
  // CTA (b, 0) reduces chunk b; the helpers fill the rows no segment owns
  const int tail_ctas = (C + THREADS - 1) / THREADS;
  const int helpers = tail_ctas < MAX_HELPERS ? tail_ctas : MAX_HELPERS;
  capscore_agg_kernel<<<dim3(B, 1 + helpers), THREADS, STAGE_BYTES, stream>>>(
      ks, eids, ws, seg, C, ls, taus, L, salts, salt, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int capscore_agg_launch(const int* ks, const int* eids,
                                   const float* ws, const int* seg, int C,
                                   const float* ls, const float* taus, int L,
                                   unsigned int salt, float* w_total,
                                   unsigned char* entered, float* contrib,
                                   float* kb_min, float* min_score,
                                   void* stream_ptr) {
  return launch(ks, eids, ws, seg, 1, C, ls, taus, L, nullptr, salt, w_total,
                entered, contrib, kb_min, min_score, stream_ptr);
}

// A batch of B chunks: ks, eids, seg int32 and ws f32, each [B, C] (row b
// key-sorted with its dense segment ids); ls f32 [L], shared; taus f32
// [B, L]; salts uint32 [B].  Outputs w_total f32 [B, C]; entered u8,
// contrib, kb_min, min_score f32, each [B, L, C].
extern "C" int capscore_agg_batch_launch(const int* ks, const int* eids,
                                         const float* ws, const int* seg, int B,
                                         int C, const float* ls, const float* taus,
                                         int L, const unsigned int* salts,
                                         float* w_total, unsigned char* entered,
                                         float* contrib, float* kb_min,
                                         float* min_score, void* stream_ptr) {
  return launch(ks, eids, ws, seg, B, C, ls, taus, L, salts, 0u, w_total,
                entered, contrib, kb_min, min_score, stream_ptr);
}
