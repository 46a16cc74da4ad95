// K1: flash-attention forward with segment ids, causal masking and GQA,
// bf16 in and out, fp32 accumulation and softmax statistics; ALiBi, sliding
// window and a query offset as modes.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_fwd_impl). Same contract: a query attends a key
// iff both carry the same nonzero segment id and, when causal, the key's
// index is not past the query's; query head h reads kv head h / (H / KVH);
// the log-sum-exp (natural log) of every row is written for the backward.
// The modes, with row = q_off + query index and col = key index:
//   - q_off: the position of query row 0 (a shard of the queries against
//     all keys, Sq != Skv); the causal, window and ALiBi terms use row;
//   - window > 0: a pair is live only if row - col < window;
//   - alibi: logit += -slope_h * (row - col), slope_h = 2^(-8 (h + 1) / H)
//     of the query head h, folded into the exp2 domain; LSE includes it.
// All three are uniform runtime arguments of the one kernel: with alibi = 0,
// window = 0 and q_off = 0 the terms vanish.
//
// What bounds it on an H100: at the llava-1.5-7b prefill shape (B=4, H=32,
// S=623, D=128) the live causal QK^T and PV are ~12.5 GFLOP against ~82 MB
// of q, k, v and o, ~150 FLOP per byte, below the ~295 FLOP/byte ridge: read
// once, the bytes bound it at ~25 us. One 4,608-token row under a 4,096
// window (Mistral's long-row prefill) is ~172 GFLOP: the tensor cores bound
// it at ~0.17 ms.
//
// The design (the shape FlashAttention-3 takes on Hopper):
//   - a block owns 128 query rows of one (batch row, query head) and has
//     384 threads: two consumer warpgroups of 64 rows each (one wgmma m64
//     tile) and a producer warpgroup, whose registers setmaxnreg lowers to
//     40 so that the consumers' can rise to 232; one warp of it works;
//   - the producer's lane 0 brings the Q tile once and the K and V tiles
//     of BK keys (64 or 128, the wrapper's plan) into a ring of STAGES
//     stages with TMA (tensor maps over the (D, heads, S, B) strides,
//     128-byte swizzle, rows past Sq or Skv zero-filled), each stage with a
//     full and an empty mbarrier; the warp's 32 lanes bring the tile's key
//     segment ids into the stage with plain loads issued a tile ahead and
//     reduce their range, and a tile that no row of the block can attend is
//     passed through the ring without a copy;
//   - S = Q K^T is wgmma m64nBKk16 with both operands K-major in shared
//     memory; the mask, the scale, the ALiBi term and the online softmax run
//     in registers on the accumulator layout, compiled once for each of
//     {masked, full} x {ALiBi, none}. The per-pair mask runs only on tiles
//     where some pair of the warpgroup's rows can be masked (across the
//     causal diagonal or the window's edge, at the ragged end of Skv, at a
//     segment boundary: found from the tile's and the rows' id ranges);
//     tiles that no pair can use are skipped (causal, window, disjoint
//     ids). On a full tile without ALiBi the row max runs on the raw logits
//     and the scale folds into the exp2's FFMA; O is rescaled only where a
//     row max of the warp moved;
//   - O += P V is wgmma m64n128k16 with A = P in registers: the bf16-packed
//     accumulator of S is the A fragment, so P never leaves registers; B is
//     the V tile, N-major through the transpose bit. P goes in as two bf16
//     terms, its rounded value and what the rounding left (~16 of fp32's 24
//     bits, two products per k-step): rounded once, as the Pallas kernel
//     rounds it, the train step's loss on MPT-7B read 1.38x the bound of its
//     kernel-vs-plain comparison (PERF.md section 6);
//   - a warpgroup releases a stage to the producer once its PV product on
//     it has been waited; the two warpgroups run their tiles independently,
//     so one's softmax overlaps the other's tensor work. Every branch
//     around a wgmma is on a value broadcast from lane 0, so the compiler
//     knows it is warp-uniform and keeps the wgmma asynchronous;
//   - query tiles are scheduled last-first (most key tiles first under a
//     causal mask); one block per SM, the ring in dynamic shared memory.
// Clock stamps of a copy (scripts/flash_fwd_phases.py) put a key tile's
// time in its softmax: exp2 runs on the SM's 16 multi-function units a
// clock, 4,096 of them per 64 x 64 tile of a warpgroup. Tried and not kept
// (PERF.md section 6): issuing tile i's Q K^T before tile i-1's P V within a
// warpgroup, and the two warpgroups taking turns at the tensor cores.
// No float atomics: the result is bitwise repeatable and a CUDA graph can
// capture the launch.
//
// The tile rule (skip / masked / full) is ops/flash_attention.py:
// flash_tile_kind, and flash_attention_tiled_plain walks the tiles in this
// kernel's order with it. Inputs are in the framework's (B, S, H, D) layout,
// read through the tensor maps' strides: no transposed copy is made. Rows of
// a fully masked query (segment id 0) come out as 0 with LSE = M_INIT * ln 2.

#include <cuda.h>  // CUtensorMap (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using halva::mbar_arrive;
using halva::mbar_expect_tx;
using halva::mbar_init;
using halva::mbar_wait;
using halva::named_sync;
using halva::smem_u32;
using halva::sw128_desc;
using halva::tma_load_4d;
using halva::flash::D;
using halva::flash::HALF_COLS;
using halva::flash::IMAX;
using halva::flash::IMIN;
using halva::flash::LOG2E;
using halva::flash::MASKED;
using halva::flash::SKIP;
using halva::flash::fast_exp2;
using halva::flash::pack_bf16;
using halva::flash::tile_kind;
using halva::flash::warp_range;

constexpr int BQ = 128;         // query rows per block
constexpr int WG_ROWS = 64;     // rows per consumer warpgroup
constexpr int NTHREADS = 384;   // two consumer warpgroups + the producer's
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int Q_HALF = BQ * 128;          // bytes of one half of the Q tile
constexpr int Q_BYTES = 2 * Q_HALF;       // 32 KB
constexpr float NEG_BIG = -1e30f;  // logit of a masked pair (selected, not added)
constexpr float M_INIT = -1e29f;   // running-max start above NEG_BIG: masked p = 0
constexpr float LN2 = 0.6931471805599453f;

template <int BK, int STAGES>
struct Plan {
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;   // K then V
  static constexpr int SEG_INTS = BK + 4;  // the ids, then {min, max} of them
  // 1 KB of slack to align the swizzled tiles to 1024 bytes
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                              STAGES * SEG_INTS * 4 + (2 * STAGES + 1) * 8;
};

// (lo, hi) as two bf16 pairs whose sum keeps ~16 mantissa bits of each:
// the rounded values and what the rounding left
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big,
                                           uint32_t& rest) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 bf = __bfloat1622float2(b);
  big = *reinterpret_cast<const uint32_t*>(&b);
  rest = pack_bf16(lo - bf.x, hi - bf.y);
}

// S (64 x BK) = Q (this warpgroup's 64 rows) K^T: both K-major, each row's
// 128 head-dim columns in two 128-byte swizzled halves
template <int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint32_t qa,
                                        uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        sw128_desc(qa + (kk >> 2) * Q_HALF + (kk & 3) * 32, 16, 1024);
    const uint64_t db =
        sw128_desc(kb + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024);
    if constexpr (BK == 128)
      halva::wgmma_m64n128_ss<0>(s, da, db, kk > 0);
    else
      halva::wgmma_m64n64_ss<0>(s, da, db, kk > 0);
  }
}

// The online softmax of one key tile on S's accumulator layout (this
// thread's rows p0 and p0 + 8, columns 8 j + 2 tig + {0, 1}): P = exp2 of
// the logits in the exp2 domain less the new row max, left in s; m and l
// updated; returns the factors that rescale O's two rows. MASKED: pairs the
// mask rules out become NEG_BIG (a full tile skips every test); ALIBI: the
// bias -slope2 (row - col). Without either the scale folds into the exp2's
// FFMA and the max runs on the raw logits (the scale is positive).
template <int BK, bool MASKED, bool ALIBI>
__device__ __forceinline__ float2 softmax_tile(
    float (&s)[BK / 2], const int* sg, int c0, int p0, int p1, int qs0,
    int qs1, int tig, int Skv, int causal, int window, float scale_log2,
    float slope2, float& m0, float& m1, float& l0, float& l1) {
  constexpr bool SCALED = MASKED || ALIBI;  // s holds exp2-domain logits
  if (SCALED) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int cl = 8 * j + 2 * tig;
      int2 cs = make_int2(0, 0);
      if (MASKED) cs = *reinterpret_cast<const int2*>(sg + cl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + cl + (e & 1);
        const int pr = (e & 2) ? p1 : p0;
        float x = s[4 * j + e] * scale_log2;
        if (ALIBI) x = fmaf(-slope2, (float)(pr - col), x);
        if (MASKED) {
          const int qs = (e & 2) ? qs1 : qs0;
          const int c = (e & 1) ? cs.y : cs.x;
          bool ok = col < Skv && c == qs && qs != 0;
          if (causal) ok = ok && pr >= col;
          if (window > 0) ok = ok && pr - col < window;
          x = ok ? x : NEG_BIG;
        }
        s[4 * j + e] = x;
      }
    }
  }
  // row maxima: each thread's 2 x BK / 4 values as a tree, then the quad
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[r][k] = M_INIT;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][(j & 1) * 2 + (e & 1)] =
          fmaxf(mx[e >> 1][(j & 1) * 2 + (e & 1)], s[4 * j + e]);
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if (!SCALED) {
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float2 al = make_float2(fast_exp2(m0 - mn0), fast_exp2(m1 - mn1));
  m0 = mn0;
  m1 = mn1;
  const float sc = SCALED ? 1.f : scale_log2;
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const float mn = (e & 2) ? mn1 : mn0;
    s[e] = fast_exp2(fmaf(s[e], sc, -mn));
    sum[(e >> 1) & 1][e & 1] += s[e];
  }
  float sum0 = sum[0][0] + sum[0][1], sum1 = sum[1][0] + sum[1][1];
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l0 = l0 * al.x + sum0;
  l1 = l1 * al.y + sum1;
  return al;
}

// grid (H, B, query tiles), last query tile first. Warps 0-7 are the two
// consumer warpgroups; warps 8-11 the producer warpgroup, of which warp 8
// works and the others only give up their registers.
template <int BK, int STAGES>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const int* __restrict__ qseg, const int* __restrict__ kvseg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, int KVH, float scale_log2,
                 int causal, int alibi, int window, int q_off) {
  using P = Plan<BK, STAGES>;
  static_assert(BK == 64 || BK == 128, "key tile");
  static_assert(P::SMEM <= 232448 - 1024, "shared memory of one block");
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int2 wg_range[2][4];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = q_s + Q_BYTES;  // stage st: K at + st * STAGE_BYTES
  const uint32_t seg_s = kv_s + STAGES * P::STAGE_BYTES;
  const uint32_t full = seg_s + STAGES * P::SEG_INTS * 4;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;
  int* segs = reinterpret_cast<int*>(smem + (seg_s - raw));

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the block's key tiles [t_lo, t_hi): causal and window bounds of its rows
  const int bp_lo = q_off + q0, bp_hi = q_off + min(q0 + BQ, Sq) - 1;
  int t_hi = (Skv + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, bp_hi / BK + 1);
  const int t_lo =
      window > 0 && bp_lo - window + 1 > 0 ? (bp_lo - window + 1) / BK : 0;
  const int n = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 32);  // every producer lane
      mbar_init(empty + 8 * st, 8);  // every consumer warp
    }
    mbar_init(qbar, 1);
    halva::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 8) return;
    // the segment-id range of the block's rows below Sq
    int qmin = IMAX, qmax = IMIN;
#pragma unroll
    for (int j = 0; j < BQ / 32; ++j) {
      const int r = q0 + lane + 32 * j;
      if (r < Sq) {
        const int v = qseg[(long)b * Sq + r];
        qmin = min(qmin, v);
        qmax = max(qmax, v);
      }
    }
    warp_range(qmin, qmax);
    if (lane == 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      tma_load_4d(q_s, &qmap, qbar, 0, h, q0, b);
      tma_load_4d(q_s + Q_HALF, &qmap, qbar, HALF_COLS, h, q0, b);
    }
    const int* ks = kvseg + (long)b * Skv;
    int next[BK / 32];
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = t_lo * BK + lane + 32 * j;
      next[j] = n > 0 && c < Skv ? ks[c] : 0;
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const int c0 = (t_lo + i) * BK;
      int sv[BK / 32];
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        sv[j] = next[j];
        const int c = c0 + BK + lane + 32 * j;
        next[j] = i + 1 < n && c < Skv ? ks[c] : 0;
      }
      int kmin = IMAX, kmax = IMIN;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < Skv) {
          kmin = min(kmin, sv[j]);
          kmax = max(kmax, sv[j]);
        }
      }
      warp_range(kmin, kmax);
      const int kind = tile_kind<BK>(c0, kmin, kmax, qmin, qmax, bp_lo, bp_hi,
                                     Skv, causal, window);
      if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);
      int* sg = segs + st * P::SEG_INTS;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) sg[lane + 32 * j] = sv[j];
      if (lane == 0) {
        sg[BK] = kmin;
        sg[BK + 1] = kmax;
      }
      const uint32_t fb = full + 8 * st;
      if (lane == 0 && kind != SKIP) {
        const uint32_t kd = kv_s + st * P::STAGE_BYTES;
        const uint32_t vd = kd + P::KV_BYTES;
        mbar_expect_tx(fb, P::STAGE_BYTES);
        tma_load_4d(kd, &kmap, fb, 0, kvh, c0, b);
        tma_load_4d(kd + BK * 128, &kmap, fb, HALF_COLS, kvh, c0, b);
        tma_load_4d(vd, &vmap, fb, 0, kvh, c0, b);
        tma_load_4d(vd + BK * 128, &vmap, fb, HALF_COLS, kvh, c0, b);
      } else {
        mbar_arrive(fb);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int row_base = q0 + wg * WG_ROWS;
  const int r0 = row_base + wq * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int p0 = q_off + r0, p1 = p0 + 8;
  const int qs0 = r0 < Sq ? qseg[(long)b * Sq + r0] : 0;
  const int qs1 = r1 < Sq ? qseg[(long)b * Sq + r1] : 0;
  // the segment-id range of this warpgroup's rows below Sq
  int qmin = IMAX, qmax = IMIN;
  if (r0 < Sq) qmin = qmax = qs0;
  if (r1 < Sq) {
    qmin = min(qmin, qs1);
    qmax = max(qmax, qs1);
  }
  warp_range(qmin, qmax);
  if (lane == 0) wg_range[wg][wq] = make_int2(qmin, qmax);
  named_sync(1 + wg, 128);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    qmin = min(qmin, wg_range[wg][w].x);
    qmax = max(qmax, wg_range[wg][w].y);
  }
  if (qmin > qmax) qmin = qmax = 0;  // no row below Sq
  const int p_lo = q_off + row_base;
  const int p_hi = q_off + min(row_base + WG_ROWS, Sq) - 1;
  // ALiBi slope of this query head in the exp2 domain (0 = no bias)
  const float slope2 =
      alibi ? exp2f(-8.f * (float)(h + 1) / (float)H) * LOG2E : 0.f;

  float oacc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) oacc[e] = 0.f;
  float m0 = M_INIT, m1 = M_INIT, l0 = 0.f, l1 = 0.f;
  const uint32_t qa = q_s + wg * WG_ROWS * 128;
#define SOFTMAX_ARGS                                                      \
  s, sg, c0, p0, p1, qs0, qs1, tig, Skv, causal, window, scale_log2,      \
      slope2, m0, m1, l0, l1
  mbar_wait(qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    const int c0 = (t_lo + i) * BK;
    mbar_wait(full + 8 * st, (i / STAGES) & 1);
    const int* sg = segs + st * P::SEG_INTS;
    // broadcast from lane 0: the compiler then knows the branches around
    // the wgmma instructions are warp-uniform and does not serialize them
    const int kind = __shfl_sync(
        0xffffffffu,
        tile_kind<BK>(c0, sg[BK], sg[BK + 1], qmin, qmax, p_lo, p_hi, Skv,
                      causal, window),
        0);
    if (kind != SKIP) {
      const uint32_t kb = kv_s + st * P::STAGE_BYTES;
      const uint32_t vb = kb + P::KV_BYTES;
      float s[BK / 2];
      halva::wgmma_fence();
      qk_tile<BK>(s, qa, kb);
      halva::wgmma_commit();
      halva::wgmma_wait<0>();

      // the softmax of this tile, P in s; O rescaled where a row max moved
      float2 al;
      if (kind == MASKED || scale_log2 <= 0.f)  // the raw max needs scale > 0
        al = alibi ? softmax_tile<BK, true, true>(SOFTMAX_ARGS)
                   : softmax_tile<BK, true, false>(SOFTMAX_ARGS);
      else
        al = alibi ? softmax_tile<BK, false, true>(SOFTMAX_ARGS)
                   : softmax_tile<BK, false, false>(SOFTMAX_ARGS);
      if (!__all_sync(0xffffffffu, al.x == 1.f && al.y == 1.f)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) oacc[e] *= (e & 2) ? al.y : al.x;
      }

      // O += P V: the bf16-packed S accumulators of key columns 16 kk ..
      // 16 kk + 15 (n-tiles 2 kk, 2 kk + 1) are the A fragment of k-step kk;
      // B = 16 keys of V (two 8-key groups SBO apart) by the two 64-column
      // halves (LBO apart), N-major
      uint32_t pa[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa[kk][r],
                     pl[kk][r]);
      halva::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * 16 * 128, BK * 128, 1024);
        halva::wgmma_m64n128_rs<1>(oacc, pa[kk], db, 1);
        halva::wgmma_m64n128_rs<1>(oacc, pl[kk], db, 1);
      }
      halva::wgmma_commit();
      halva::wgmma_wait<0>();
    }
    // this warp's reads of the stage are done (its wgmma groups waited)
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

#undef SOFTMAX_ARGS
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long q_row = (long)H * D;  // elements between sequence positions
  __nv_bfloat16* ob = o + (long)b * Sq * q_row + (long)h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) =
          pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) =
          pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
  if (tig == 0) {
    float* lb = lse + ((long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = m0 * LN2 + logf(l0 > 0.f ? l0 : 1.f);
    if (r1 < Sq) lb[r1] = m1 * LN2 + logf(l1 > 0.f ? l1 : 1.f);
  }
}

template <int BK, int STAGES>
auto kernel_of() {
  return flash_fwd_kernel<BK, STAGES>;
}

// setmaxnreg's pool, checked once per instance (a shortfall would hang)
template <int BK, int STAGES>
int check_registers() {
  static const int ok = halva::flash::setmaxnreg_pool_ok(
      kernel_of<BK, STAGES>(), NTHREADS, 256, CONSUMER_REGS, PRODUCER_REGS);
  return ok;
}

template <int BK, int STAGES>
int launch(cudaStream_t st, const void* q, const void* k, const void* v,
           const int* qs, const int* kvs, __nv_bfloat16* op, float* lp,
           int B, int Sq, int Skv, int H, int KVH, float sl2, int causal,
           int alibi, int window, int q_off) {
  using P = Plan<BK, STAGES>;
  static uint64_t smem_set = 0;
  int err = check_registers<BK, STAGES>();
  if (err) return err;
  CUtensorMap qmap, kmap, vmap;
  if ((err = halva::flash::encode_bshd(&qmap, q, B, Sq, H, BQ))) return err;
  if ((err = halva::flash::encode_bshd(&kmap, k, B, Skv, KVH, BK))) return err;
  if ((err = halva::flash::encode_bshd(&vmap, v, B, Skv, KVH, BK))) return err;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  auto kernel = kernel_of<BK, STAGES>();
  if (!(smem_set >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set |= uint64_t(1) << dev;
  }
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NTHREADS, P::SMEM, st>>>(qmap, kmap, vmap, qs, kvs, op, lp,
                                          Sq, Skv, H, KVH, sl2, causal,
                                          alibi, window, q_off);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, KVH, D) bf16, 16-byte aligned; qseg (B, Sq),
// kvseg (B, Skv) int32; o (B, Sq, H, D) bf16; lse (B, H, Sq) fp32. alibi 0 |
// 1, window 0 = none, q_off >= 0; bk: keys per tile, 64 (a ring of 4 stages)
// or 128 (2 stages). Returns a cudaError_t.
extern "C" int halva_flash_fwd_bf16(const void* q, const void* k,
                                    const void* v, const void* qseg,
                                    const void* kvseg, void* o, void* lse,
                                    int B, int Sq, int Skv, int H, int KVH,
                                    int D_, float scale, int causal,
                                    int alibi, int window, int q_off, int bk,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 ||
      window < 0 || q_off < 0 || D_ != D)  // the head dim of every config
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  const auto* qs = static_cast<const int*>(qseg);
  const auto* kvs = static_cast<const int*>(kvseg);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (bk == 128)
    return launch<128, 2>(st, q, k, v, qs, kvs, op, lp, B, Sq, Skv, H, KVH,
                          sl2, causal, alibi, window, q_off);
  if (bk == 64)
    return launch<64, 4>(st, q, k, v, qs, kvs, op, lp, B, Sq, Skv, H, KVH,
                         sl2, causal, alibi, window, q_off);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* halva_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
