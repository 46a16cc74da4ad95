// K2 and K3: FlashAttention-2 backward with segment ids, causal masking and
// GQA, bf16 in and out, fp32 accumulation; ALiBi, sliding window and a query
// offset as modes.
//
// Replace the Pallas TPU kernels halva_tpu/ops/flash_attention.py:
//   K2 _bwd_dq_kernel  (pallas_call in _flash_bwd): dQ
//   K3 _bwd_dkv_kernel (pallas_call in _flash_bwd): dK, dV
// Same contract: a query attends a key iff both carry the same nonzero
// segment id and, when causal, the key's index is not past the query's;
// query head h reads kv head h / (H / KVH). With S = Q K^T * scale, the
// forward's natural-log LSE and delta = rowsum(dO * O) (computed outside, as
// XLA computes it in the reference):
//   P  = exp(S - LSE) where attended, else 0 (selected, never multiplied:
//        K1 writes LSE = -1e29 ln 2 for a fully masked row, and exp(S - LSE)
//        overflows there)
//   dP = dO V^T,  dS = P * (dP - delta) * scale, rounded to bf16
//   dQ = dS K,    dK = dS^T Q (summed over the G query heads of a kv head),
//   dV = P^T dO   (P rounded to bf16 first), all accumulated in fp32.
// The modes are K1's, with row = q_off + query index and col = key index:
// causal and window (row - col < window) in the mask, the ALiBi bias
// -slope_h * (row - col) of the query head h added to the recomputed logit
// (no gradient flows to the slope). K2 skips the key tiles K1 skips; K3
// starts at the first query tile that can see its keys (shifted by q_off)
// and stops before the query tiles wholly past its keys' window; under GQA
// it takes the slope of each of its G query heads in turn. All three are
// uniform runtime arguments of the one kernel each: at alibi = 0, window = 0
// and q_off = 0 the terms vanish and the results are the base mode's.
//
// What bounds them on an H100: at the llava-1.5-7b train shape (B=4 rows of
// S=1087, H=32, D=128, causal) K2 does 3 and K3 4 products of 2*D FLOP per
// live (query, key) pair, ~58 and ~78 GFLOP, against ~250 MB of q, k, v, dO
// and the three gradients: ~500 FLOP per byte, above the H100's ~295 ridge,
// so the tensor cores bound them (~60 and ~80 us at 989 TFLOP/s). These
// first versions are far from that, bound by latency like K1: synchronous
// tile loads, mma.sync m16n8k16, 4 warps a block.
//
// Design:
//   - K2: one block of 4 warps per (64-query tile, head, batch row), as K1;
//     each warp keeps its 16 rows of Q and dO as A fragments in registers
//     and its dQ accumulator (16 x 128 fp32) for the whole key loop; K and V
//     tiles of 64 keys are staged in shared memory (padded rows, conflict-free
//     fragment reads). Per 32-key half tile: S and dP (two products whose B
//     operands are K and V rows), P and dS in registers, then dS, packed to
//     bf16 as an A operand, times K read transposed with ldmatrix.trans. The
//     key loop stops at the diagonal (the reference's causal block skip).
//   - K3: one block of 4 warps per (64-key tile, kv head, batch row); each
//     warp owns 16 keys and keeps dK and dV (16 x 128 fp32 each) in registers
//     across every query tile of every query head of its kv head: the GQA sum
//     happens in registers, with no second pass and no atomics, so the result
//     is deterministic. It works on the transposed problem, S^T = K Q^T, so
//     P^T and dS^T come out of the accumulators already in the A-operand
//     layout of dV += P^T dO and dK += dS^T Q, whose B operands (dO and Q
//     rows) are read transposed from shared memory. The query loop starts at
//     the first tile that can see the key tile.
//   - Tails: rows past Sq or Skv load as zeros with segment id 0, so they
//     are masked, and are never stored; S = 1087 needs no padding by the
//     caller.
// Not done yet (later work): wgmma, TMA or cp.async pipelining, a split of
// the query loop of K3 for the long causal tiles. Head dim 128 only, as K1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using halva::ld32;
using halva::ldmatrix_x4_trans;
using halva::mma_16816;
using halva::pack_bf16;

constexpr int BQ = 64;       // queries per tile
constexpr int BK = 64;       // keys per tile
constexpr int SUB = 32;      // queries (K3) or keys (K2) per inner step
constexpr int NWARPS = 4;    // 16 rows (K2: queries, K3: keys) per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// Stage `rows` rows of D bf16 (row stride `row_elems` in global memory) into
// shared memory with padded row stride D + 8; rows at or past `limit` are 0.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long row_elems, int first,
                                           int rows, int limit) {
  constexpr int STR = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit)
      x = *reinterpret_cast<const uint4*>(src + (first + r) * row_elems + c);
    *reinterpret_cast<uint4*>(dst + r * STR + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kvseg,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                    int KVH, float scale, float scale_log2, int causal,
                    int alibi, int window, int q_shift) {
  constexpr int STR = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BK * STR];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * STR];
  __shared__ int kvsegs[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  // global positions: of the tile's first row, and of this thread's two
  const int p_tile = q0 + q_shift;
  const int p0 = r0 + q_shift;
  const int p1 = p0 + 8;
  // ALiBi slope of this query head in the exp2 domain (0 = no bias)
  const float slope2 =
      alibi ? exp2f(-8.f * (float)(h + 1) / (float)H) * LOG2E : 0.f;

  const long q_row = (long)H * D;  // elements between sequence positions
  const long kv_row = (long)KVH * D;
  const long q_off = (long)b * Sq * q_row + (long)h * D;
  const __nv_bfloat16* qb = q + q_off;
  const __nv_bfloat16* dob = dout + q_off;
  const __nv_bfloat16* kb = k + (long)b * Skv * kv_row + (long)kvh * D;
  const __nv_bfloat16* vb = v + (long)b * Skv * kv_row + (long)kvh * D;

  // Q and dO as A operands, for the whole key loop
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = r0 < Sq ? ld32(qb + r0 * q_row + c) : 0u;
    qf[kk][1] = r1 < Sq ? ld32(qb + r1 * q_row + c) : 0u;
    qf[kk][2] = r0 < Sq ? ld32(qb + r0 * q_row + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ld32(qb + r1 * q_row + c + 8) : 0u;
    df[kk][0] = r0 < Sq ? ld32(dob + r0 * q_row + c) : 0u;
    df[kk][1] = r1 < Sq ? ld32(dob + r1 * q_row + c) : 0u;
    df[kk][2] = r0 < Sq ? ld32(dob + r0 * q_row + c + 8) : 0u;
    df[kk][3] = r1 < Sq ? ld32(dob + r1 * q_row + c + 8) : 0u;
  }
  const int qs0 = r0 < Sq ? qseg[(long)b * Sq + r0] : 0;
  const int qs1 = r1 < Sq ? qseg[(long)b * Sq + r1] : 0;
  const long stat = ((long)b * H + h) * Sq;
  const float lse0 = r0 < Sq ? lse[stat + r0] * LOG2E : 0.f;
  const float lse1 = r1 < Sq ? lse[stat + r1] * LOG2E : 0.f;
  const float dl0 = r0 < Sq ? delta[stat + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[stat + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (p_tile + BQ - 1) / BK + 1);
  // first key tile with a pair inside the window, as K1
  const int t_lo = window > 0 ? max((p_tile - window + 1) / BK, 0) : 0;
  const int lrow = (lane & 7) + (lane & 8);  // ldmatrix.trans addressing
  const int lcol = (lane & 16) >> 1;

  for (int t = t_lo; t < n_tiles; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // the previous tile's shared reads are done
    stage_rows<D>(ks, kb, kv_row, c0, BK, Skv);
    stage_rows<D>(vs, vb, kv_row, c0, BK, Skv);
    if (threadIdx.x < BK)
      kvsegs[threadIdx.x] =
          c0 + threadIdx.x < Skv ? kvseg[(long)b * Skv + c0 + threadIdx.x] : 0;
    __syncthreads();

#pragma unroll 1
    for (int sb = 0; sb < BK / SUB; ++sb) {
      // S = Q K^T and dP = dO V^T for 16 rows x 32 keys; B operand b0 =
      // K[key g][dims 2t..2t+1] (and V's), read straight from row-major smem
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        const int kr = (sb * SUB + nt * 8 + g) * STR + tig * 2;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma_16816(s[nt], qf[kk], ld32(ks + kr + kk * 16),
                    ld32(ks + kr + kk * 16 + 8));
          mma_16816(dp[nt], df[kk], ld32(vs + kr + kk * 16),
                    ld32(vs + kr + kk * 16 + 8));
        }
      }
      // P by the mask (selected), then dS in place of S
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = sb * SUB + nt * 8 + tig * 2 + e;
          const int col = c0 + cl;
          const int cs = kvsegs[cl];
          const bool in = col < Skv;
          bool ok0 = in && qs0 != 0 && cs == qs0 && (!causal || p0 >= col);
          bool ok1 = in && qs1 != 0 && cs == qs1 && (!causal || p1 >= col);
          float s0 = s[nt][e] * scale_log2, s1 = s[nt][2 + e] * scale_log2;
          if (window > 0) {
            ok0 = ok0 && p0 - col < window;
            ok1 = ok1 && p1 - col < window;
          }
          s0 -= slope2 * (float)(p0 - col);
          s1 -= slope2 * (float)(p1 - col);
          const float prob0 = ok0 ? exp2f(s0 - lse0) : 0.f;
          const float prob1 = ok1 ? exp2f(s1 - lse1) : 0.f;
          s[nt][e] = prob0 * (dp[nt][e] - dl0) * scale;
          s[nt][2 + e] = prob1 * (dp[nt][2 + e] - dl1) * scale;
        }
      }
      // dQ += dS K: the dS accumulators of key groups 2kk, 2kk+1 are the A
      // operand of k-step kk; B (keys x dims) from row-major K via
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const __nv_bfloat16* kr = ks + (sb * SUB + kk * 16 + lrow) * STR + lcol;
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kr + dt * 8);
          mma_16816(acc[dt], pa, bk[0], bk[1]);
          mma_16816(acc[dt + 1], pa, bk[2], bk[3]);
        }
      }
    }
  }

  __nv_bfloat16* dqb = dq + q_off;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * q_row + c) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * q_row + c) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V (BK rows), Q, dO (BQ rows), padded; query segment ids, LSE, delta
  return (2 * BK + 2 * BQ) * (D + 8) * 2 + 3 * BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kvseg,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                     int KVH, float scale, float scale_log2, int causal,
                     int alibi, int window, int q_shift) {
  constexpr int STR = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BK * STR;
  __nv_bfloat16* qs = vs + BK * STR;
  __nv_bfloat16* dos = qs + BQ * STR;
  int* qsegs = reinterpret_cast<int*>(dos + BQ * STR);
  float* lses = reinterpret_cast<float*>(qsegs + BQ);
  float* dls = lses + BQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kv0 = kt * BK;
  const int lk = warp * 16;        // this warp's first key row in the tile
  const int kr0 = kv0 + lk + g;    // this thread's two key rows
  const int kr1 = kr0 + 8;

  const long q_row = (long)H * D;
  const long kv_row = (long)KVH * D;
  const long kv_off = (long)b * Skv * kv_row + (long)kvh * D;
  // segment 0 past Skv: such a key matches no query
  const int ks0 = kr0 < Skv ? kvseg[(long)b * Skv + kr0] : 0;
  const int ks1 = kr1 < Skv ? kvseg[(long)b * Skv + kr1] : 0;

  stage_rows<D>(ks, k + kv_off, kv_row, kv0, BK, Skv);
  stage_rows<D>(vs, v + kv_off, kv_row, kv0, BK, Skv);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  // first query tile that can see us: local row i sits at position
  // q_shift + i, the key tile starts at position kv0
  const int qt_lo = causal ? max(kv0 - q_shift, 0) / BQ : 0;
  int n_qt = (Sq + BQ - 1) / BQ;
  if (window > 0) {
    // query tile qt lies wholly past our keys' window iff its least
    // row - col, (qt * BQ + q_shift) - (kv0 + BK - 1), is already >= window
    const int past = kv0 + BK - 1 + window - q_shift;
    n_qt = min(n_qt, past > 0 ? (past + BQ - 1) / BQ : 0);
  }
  const int lrow = (lane & 7) + (lane & 8);
  const int lcol = (lane & 16) >> 1;
  const __nv_bfloat16* ka = ks + (lk + g) * STR + tig * 2;  // A fragments
  const __nv_bfloat16* va = vs + (lk + g) * STR + tig * 2;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const long q_off = (long)b * Sq * q_row + (long)h * D;
    const long stat = ((long)b * H + h) * Sq;
    // ALiBi slope of this query head in the exp2 domain (0 = no bias)
    const float slope2 =
        alibi ? exp2f(-8.f * (float)(h + 1) / (float)H) * LOG2E : 0.f;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's shared reads are done
      stage_rows<D>(qs, q + q_off, q_row, q0, BQ, Sq);
      stage_rows<D>(dos, dout + q_off, q_row, q0, BQ, Sq);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        const bool in = r < Sq;
        qsegs[threadIdx.x] = in ? qseg[(long)b * Sq + r] : 0;
        lses[threadIdx.x] = in ? lse[stat + r] * LOG2E : 0.f;
        dls[threadIdx.x] = in ? delta[stat + r] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int sb = 0; sb < BQ / SUB; ++sb) {
        // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries: A = this
        // warp's K (V) rows, B operand b0 = Q[query g][dims 2t..2t+1]
        float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk * 16;
          const uint32_t kf[4] = {ld32(ka + c), ld32(ka + 8 * STR + c),
                                  ld32(ka + c + 8), ld32(ka + 8 * STR + c + 8)};
          const uint32_t vf[4] = {ld32(va + c), ld32(va + 8 * STR + c),
                                  ld32(va + c + 8), ld32(va + 8 * STR + c + 8)};
#pragma unroll
          for (int nt = 0; nt < SUB / 8; ++nt) {
            const int qr = (sb * SUB + nt * 8 + g) * STR + tig * 2 + c;
            mma_16816(s[nt], kf, ld32(qs + qr), ld32(qs + qr + 8));
            mma_16816(dp[nt], vf, ld32(dos + qr), ld32(dos + qr + 8));
          }
        }
        // P^T by the mask (selected) into s, dS^T into dp
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = sb * SUB + nt * 8 + tig * 2 + e;
            const int qi = q0 + qc + q_shift;  // the query's position
            const int qsv = qsegs[qc];
            const float l2 = lses[qc], dl = dls[qc];
            bool ok0 = qsv != 0 && qsv == ks0 && (!causal || qi >= kr0);
            bool ok1 = qsv != 0 && qsv == ks1 && (!causal || qi >= kr1);
            float s0 = s[nt][e] * scale_log2, s1 = s[nt][2 + e] * scale_log2;
            if (window > 0) {
              ok0 = ok0 && qi - kr0 < window;
              ok1 = ok1 && qi - kr1 < window;
            }
            s0 -= slope2 * (float)(qi - kr0);
            s1 -= slope2 * (float)(qi - kr1);
            const float p0 = ok0 ? exp2f(s0 - l2) : 0.f;
            const float p1 = ok1 ? exp2f(s1 - l2) : 0.f;
            s[nt][e] = p0;
            s[nt][2 + e] = p1;
            dp[nt][e] = p0 * (dp[nt][e] - dl) * scale;
            dp[nt][2 + e] = p1 * (dp[nt][2 + e] - dl) * scale;
          }
        }
        // dV += P^T dO and dK += dS^T Q: the accumulators of query groups
        // 2kk, 2kk+1 are the A operand of k-step kk; B (queries x dims) from
        // row-major dO and Q via ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < SUB / 16; ++kk) {
          uint32_t pa[4], da[4];
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
          da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
          da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
          const int row = (sb * SUB + kk * 16 + lrow) * STR + lcol;
#pragma unroll
          for (int dt = 0; dt < D / 8; dt += 2) {
            uint32_t bd[4], bq[4];
            ldmatrix_x4_trans(bd, dos + row + dt * 8);
            mma_16816(dva[dt], pa, bd[0], bd[1]);
            mma_16816(dva[dt + 1], pa, bd[2], bd[3]);
            ldmatrix_x4_trans(bq, qs + row + dt * 8);
            mma_16816(dka[dt], da, bq[0], bq[1]);
            mma_16816(dka[dt + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + kv_off;
  __nv_bfloat16* dvb = dv + kv_off;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (kr0 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + kr0 * kv_row + c) =
          pack_bf16(dka[dt][0], dka[dt][1]);
      *reinterpret_cast<uint32_t*>(dvb + kr0 * kv_row + c) =
          pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (kr1 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + kr1 * kv_row + c) =
          pack_bf16(dka[dt][2], dka[dt][3]);
      *reinterpret_cast<uint32_t*>(dvb + kr1 * kv_row + c) =
          pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

bool valid_args(int B, int Sq, int Skv, int H, int KVH, int D, int window,
                int q_off) {
  // the head dim of every supported Llama config
  return B > 0 && Sq > 0 && Skv > 0 && KVH > 0 && H % KVH == 0 && D == 128 &&
         window >= 0 && q_off >= 0;
}

// above 48 KB of dynamic shared memory needs the opt-in, once per device (the
// first launch is never inside a CUDA graph capture: the callers warm up
// first)
cudaError_t dkv_smem_opt_in() {
  static uint64_t smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_smem_bytes<128>());
    if (err != cudaSuccess) return err;
    smem_set |= uint64_t(1) << dev;
  }
  return cudaSuccess;
}

}  // namespace

// q, dout (B, Sq, H, D), k/v (B, Skv, KVH, D) bf16; qseg (B, Sq), kvseg
// (B, Skv) int32; lse, delta (B, H, Sq) fp32; dq (B, Sq, H, D) bf16. alibi
// 0 | 1, window 0 = none, q_off >= 0, as K1 was given them. Returns a
// cudaError_t.
extern "C" int halva_flash_bwd_dq_bf16(const void* q, const void* k,
                                       const void* v, const void* qseg,
                                       const void* kvseg, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int B, int Sq, int Skv,
                                       int H, int KVH, int D, float scale,
                                       int causal, int alibi, int window,
                                       int q_off, void* stream) {
  if (!valid_args(B, Sq, Skv, H, KVH, D, window, q_off))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<128>
      <<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qseg),
          static_cast<const int*>(kvseg),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, KVH, scale,
          scale * LOG2E, causal, alibi, window, q_off);
  return (int)cudaGetLastError();
}

// As above; dk, dv (B, Skv, KVH, D) bf16, summed over each kv head's group.
extern "C" int halva_flash_bwd_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* qseg,
                                        const void* kvseg, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int Sq,
                                        int Skv, int H, int KVH, int D,
                                        float scale, int causal, int alibi,
                                        int window, int q_off,
                                        void* stream) {
  if (!valid_args(B, Sq, Skv, H, KVH, D, window, q_off))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = dkv_smem_opt_in();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Skv + BK - 1) / BK, KVH, B);
  flash_bwd_dkv_kernel<128><<<grid, NTHREADS, dkv_smem_bytes<128>(),
                              static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qseg),
          static_cast<const int*>(kvseg),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          Sq, Skv, H, KVH, scale, scale * LOG2E, causal, alibi, window,
          q_off);
  return (int)cudaGetLastError();
}
