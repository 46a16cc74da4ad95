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
// live (query, key) pair, ~49 and ~66 GFLOP, against ~140 MB of q, k, v, dO,
// the statistics and the gradients: ~500 FLOP per byte, above the H100's
// ~295 ridge, so the tensor cores bound them (~53 and ~67 us at 989
// TFLOP/s).
//
// The design is K1's (flash_fwd.cu), the shape FlashAttention-3 takes on
// Hopper: 384 threads a block, two consumer warpgroups of one wgmma m64 tile
// each and a producer warpgroup whose registers setmaxnreg lowers so that
// the consumers' can rise; one warp of it works. Its lane 0 brings the
// operands a block keeps with TMA once and streams the walked tiles through
// a ring of stages with full and empty mbarriers (tensor maps over the
// (D, heads, S, B) strides, 128-byte swizzle, rows past S zero-filled); the
// warp's 32 lanes bring the tile's segment ids (and for K3 the queries' LSE
// and delta) into the stage with plain loads and reduce their id range. A
// consumer warpgroup decides the tile's kind by ops/flash_attention.py's
// flash_tile_kind: "skip" tiles pass through the ring without a copy, the
// per-pair mask runs only on "masked" ones. Per tile a warpgroup issues its
// two products from shared memory (S and dP), computes P while the second
// runs, then dS, both in registers on the accumulator layout, and feeds
// them, packed to bf16, as wgmma's A operand from registers into the last
// products, their B the same swizzled tile read N-major through the
// transpose bit (as K1 feeds P into P V). Every branch around a wgmma is on
// a value broadcast from lane 0, so the compiler keeps the wgmma
// asynchronous.
//   - K2 (dQ): a block owns 128 query rows of one (batch row, query head),
//     64 a warpgroup, and keeps Q and dO in shared memory; K and V tiles of
//     64 keys go through a ring of 4 stages with their key segment ids; the
//     rows' LSE and delta sit in registers. Per tile: S = Q K^T and dP =
//     dO V^T (wgmma m64n64k16, both K-major), then dQ += dS K (m64n128k16,
//     K N-major). Query tiles run last-first, as in K1.
//   - K3 (dK, dV): a block owns the keys of one (batch row, kv head) and
//     keeps them in shared memory; it walks the query tiles (64 queries of
//     Q and dO, a ring of 4 stages) that can see them, for each of the G
//     query heads of the group in turn. Per tile it works on the transposed
//     problem: S^T = K Q^T and dP^T = V dO^T (m64n64k16, Q and dO K-major),
//     P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
//     (m64n128k16, dO and Q N-major). dK and dV (2 x 64 fp32 a thread) stay
//     in registers across the whole walk: the GQA sum happens there, with
//     no second pass and no atomics. Two layouts, picked by the plan
//     (flash_bwd_plan): 128 keys a block, 64 a warpgroup, both reading
//     every stage; or 64 keys a block, the two warpgroups taking alternate
//     query tiles (each its own 2 of the 4 stages) and summing their dK and
//     dV through shared memory at the end, in a fixed order. Key tiles run
//     first-first: under the causal mask the first have the most work.
// No float atomics: the results are bitwise repeatable and a CUDA graph can
// capture the launches. One block per SM; the rings are in dynamic shared
// memory, opted in for every instance at the first launch on a device.
// ops/flash_attention.py:flash_attention_bwd_tiled_plain walks the tiles in
// these kernels' order. Inputs are in the framework's (B, S, H, D) layout;
// S = 1087 needs no padding by the caller. Head dim 128 only, as K1.

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

constexpr int NTHREADS = 384;  // two consumer warpgroups + the producer's
constexpr int WG_ROWS = 64;    // rows of one warpgroup's wgmma tile
constexpr int TILE = 64;       // K2: keys per tile; K3: queries per tile
constexpr int TILE_HALF = TILE * 128;       // bytes of one half of a tile
constexpr int TILE_BYTES = 2 * TILE_HALF;   // 16 KB: 64 rows x 128 dims

// K2's geometry
struct DqPlan {
  static constexpr int BQ = 128;  // query rows per block
  static constexpr int STAGES = 4;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int Q_HALF = BQ * 128;     // bytes of one half of Q
  static constexpr int Q_BYTES = 2 * Q_HALF;  // 32 KB (and as much for dO)
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
  static constexpr int SEG_INTS = TILE + 4;  // the ids, then {min, max}
  // 1 KB of slack to align the swizzled tiles to 1024 bytes
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES +
                              STAGES * SEG_INTS * 4 + (2 * STAGES + 1) * 8;
};

// K3's geometry for KEYS keys a block
template <int KEYS>
struct DkvPlan {
  // 64: the two warpgroups share the keys and take alternate query tiles
  static constexpr bool SPLIT = KEYS == 64;
  // even, so that under SPLIT each stage serves one warpgroup only
  static constexpr int STAGES = 4;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int K_HALF = KEYS * 128;   // bytes of one half of K
  static constexpr int KV_BYTES = 2 * K_HALF;  // the K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // Q then dO
  // the queries' segment ids, LSE * log2 e, delta; then {min, max} of ids
  static constexpr int INFO_INTS = 3 * TILE + 2;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * STAGE_BYTES +
                              STAGES * INFO_INTS * 4 + (2 * STAGES + 1) * 8;
  static_assert(!SPLIT || STAGES * STAGE_BYTES >= 128 * 2 * 64 * 4,
                "the ring holds one warpgroup's dK and dV for the merge");
};

// A K-major operand (rows x 128 dims in two 128-byte swizzled halves
// `half` bytes apart) at k-step kk (16 dims) of a 64-row slice
__device__ __forceinline__ uint64_t kmajor(uint32_t rows, int half, int kk) {
  return sw128_desc(rows + (kk >> 2) * half + (kk & 3) * 32, 16, 1024);
}

// The same tile as an N-major B operand (16 of its rows by its 128 dims) at
// k-step kk, read through the transpose bit: 8-row groups SBO apart, the
// two 64-dim halves LBO apart
__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int half, int kk) {
  return sw128_desc(tile + kk * 16 * 128, half, 1024);
}

// d (64 x 64) = A (64 rows x 128 dims) B^T (64 rows x 128 dims), both
// K-major in shared memory
__device__ __forceinline__ void product_64x64(float (&d)[32], uint32_t a,
                                              int a_half, uint32_t b,
                                              int b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    halva::wgmma_m64n64_ss<0>(d, kmajor(a, a_half, kk), kmajor(b, b_half, kk),
                              kk > 0);
}

// The 64 x 64 accumulator as wgmma's A fragments, bf16: k-step kk takes
// columns 16 kk .. 16 kk + 15 (n-tiles 2 kk, 2 kk + 1)
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// d (64 x 128) += A (64 x 64, registers) B (64 rows x 128 dims, N-major)
__device__ __forceinline__ void product_rs(float (&d)[64],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b, int b_half) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    halva::wgmma_m64n128_rs<1>(d, a[kk], nmajor(b, b_half, kk), 1);
}

// K2's P of one key tile on S's accumulator layout (this thread's rows at
// positions p0 and p0 + 8, columns 8 j + 2 tig + {0, 1}): exp2 of the
// exp2-domain logit less the row's LSE * log2 e, left in s. MASKED: pairs
// the mask rules out are selected to 0 (a full tile skips every test);
// ALIBI: the bias -slope2 (row - col).
template <bool MASKED, bool ALIBI>
__device__ __forceinline__ void dq_probs(float (&s)[32], const int* sg, int c0,
                                         int p0, int p1, int qs0, int qs1,
                                         float l0, float l1, int tig, int Skv,
                                         int causal, int window,
                                         float scale_log2, float slope2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = 8 * j + 2 * tig;
    int2 cs = make_int2(0, 0);
    if (MASKED) cs = *reinterpret_cast<const int2*>(sg + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + cl + (e & 1);
      const int pr = (e & 2) ? p1 : p0;
      float x = fmaf(s[4 * j + e], scale_log2, (e & 2) ? -l1 : -l0);
      if (ALIBI) x = fmaf(-slope2, (float)(pr - col), x);
      float p = fast_exp2(x);
      if (MASKED) {
        const int qs = (e & 2) ? qs1 : qs0;
        const int c = (e & 1) ? cs.y : cs.x;
        bool ok = col < Skv && c == qs && qs != 0;
        if (causal) ok = ok && pr >= col;
        if (window > 0) ok = ok && pr - col < window;
        p = ok ? p : 0.f;
      }
      s[4 * j + e] = p;
    }
  }
}

// K3's P^T of one query tile on S^T's accumulator layout (this thread's keys
// k0 and k0 + 8 with ids ks0, ks1; columns 8 j + 2 tig + {0, 1} the tile's
// queries, rows r0 + column at positions pq0 + column): as dq_probs, the
// queries' ids and LSE * log2 e read from the stage
template <bool MASKED, bool ALIBI>
__device__ __forceinline__ void dkv_probs(float (&s)[32], const int* info,
                                          int pq0, int k0, int k1, int ks0,
                                          int ks1, int tig, int causal,
                                          int window, float scale_log2,
                                          float slope2) {
  const float* l2 = reinterpret_cast<const float*>(info + TILE);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ql = 8 * j + 2 * tig;
    const float2 lv = *reinterpret_cast<const float2*>(l2 + ql);
    int2 qs = make_int2(0, 0);
    if (MASKED) qs = *reinterpret_cast<const int2*>(info + ql);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (e & 2) ? k1 : k0;
      const int pq = pq0 + ql + (e & 1);
      float x = fmaf(s[4 * j + e], scale_log2, (e & 1) ? -lv.y : -lv.x);
      if (ALIBI) x = fmaf(-slope2, (float)(pq - key), x);
      float p = fast_exp2(x);
      if (MASKED) {
        const int q = (e & 1) ? qs.y : qs.x;
        bool ok = q == ((e & 2) ? ks1 : ks0) && q != 0;
        if (causal) ok = ok && pq >= key;
        if (window > 0) ok = ok && pq - key < window;
        p = ok ? p : 0.f;
      }
      s[4 * j + e] = p;
    }
  }
}

// A warpgroup's id range of its rows (or keys) below `limit`: each thread
// holds two, ids v0 at index i0 and v1 at i0 + 8; [0, 0] if none
__device__ __forceinline__ int2 wg_id_range(int2 (&slots)[2][4], int wg,
                                            int wq, int lane, int i0, int v0,
                                            int v1, int limit) {
  int mn = IMAX, mx = IMIN;
  if (i0 < limit) mn = mx = v0;
  if (i0 + 8 < limit) {
    mn = min(mn, v1);
    mx = max(mx, v1);
  }
  warp_range(mn, mx);
  if (lane == 0) slots[wg][wq] = make_int2(mn, mx);
  named_sync(1 + wg, 128);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    mn = min(mn, slots[wg][w].x);
    mx = max(mx, slots[wg][w].y);
  }
  return mn > mx ? make_int2(0, 0) : make_int2(mn, mx);
}

// The epilogue of a warpgroup's 64 x 128 fp32 accumulator (this thread's
// rows 16 wq + g and + 8, columns 8 j + 2 tig + {0, 1}): packed to bf16
// into `buf`, 64 rows of two 128-byte halves `half` bytes apart (the
// warpgroup's own rows of a tile it no longer reads), each row's 16-byte
// chunks XOR-swizzled by the row so that neither the packing nor the
// read-out conflicts on the banks; then, after the warpgroup's barrier,
// written out in 16-byte stores, 16 threads a 256-byte row
__device__ __forceinline__ void stage_rows(const float (&acc)[64],
                                           unsigned char* buf, int half,
                                           int wq, int g, int tig) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * wq + g + 8 * u;
      *reinterpret_cast<uint32_t*>(buf + (j >> 3) * half + r * 128 +
                                   (((j & 7) ^ (r & 7)) << 4) + 4 * tig) =
          pack_bf16(acc[4 * j + 2 * u], acc[4 * j + 2 * u + 1]);
    }
}

// rows first .. first + 63 of `out` (row_stride elements apart) from the
// staged tile, those below `limit` only
__device__ __forceinline__ void write_rows(const unsigned char* buf, int half,
                                           __nv_bfloat16* out,
                                           long row_stride, int first,
                                           int limit) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int k = 0; k < WG_ROWS * 16 / 128; ++k) {
    const int r = (t >> 4) + 8 * k, c = t & 15;
    const uint4 v = *reinterpret_cast<const uint4*>(
        buf + (c >> 3) * half + r * 128 + (((c & 7) ^ (r & 7)) << 4));
    if (first + r < limit)
      *reinterpret_cast<uint4*>(out + (first + r) * row_stride + 8 * c) = v;
  }
}

// before generic stores into shared memory that TMA wrote and wgmma read
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ALiBi slope of query head h in the exp2 domain (0 = no bias)
__device__ __forceinline__ float alibi_slope2(int alibi, int h, int H) {
  return alibi ? exp2f(-8.f * (float)(h + 1) / (float)H) * LOG2E : 0.f;
}

// grid (H, B, query tiles), last query tile first. Warps 0-7 are the two
// consumer warpgroups; warps 8-11 the producer warpgroup, of which warp 8
// works and the others only give up their registers.
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kvseg,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                    int KVH, float scale, float scale_log2, int causal,
                    int alibi, int window, int q_off) {
  using P = DqPlan;
  constexpr int BQ = P::BQ, STAGES = P::STAGES;
  static_assert(P::SMEM <= 232448 - 1024, "shared memory of one block");
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int2 wg_range[2][4];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + P::Q_BYTES;
  const uint32_t kv_s = do_s + P::Q_BYTES;  // stage st: K at + st * STAGE_BYTES
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
  int t_hi = (Skv + TILE - 1) / TILE;
  if (causal) t_hi = min(t_hi, bp_hi / TILE + 1);
  const int t_lo =
      window > 0 && bp_lo - window + 1 > 0 ? (bp_lo - window + 1) / TILE : 0;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    if (warp > 8) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * P::Q_BYTES);
      tma_load_4d(q_s, &qmap, qbar, 0, h, q0, b);
      tma_load_4d(q_s + P::Q_HALF, &qmap, qbar, HALF_COLS, h, q0, b);
      tma_load_4d(do_s, &domap, qbar, 0, h, q0, b);
      tma_load_4d(do_s + P::Q_HALF, &domap, qbar, HALF_COLS, h, q0, b);
    }
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
    const int* ks = kvseg + (long)b * Skv;
    int next[TILE / 32];
#pragma unroll
    for (int j = 0; j < TILE / 32; ++j) {
      const int c = t_lo * TILE + lane + 32 * j;
      next[j] = n > 0 && c < Skv ? ks[c] : 0;
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const int c0 = (t_lo + i) * TILE;
      int sv[TILE / 32];
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        sv[j] = next[j];
        const int c = c0 + TILE + lane + 32 * j;
        next[j] = i + 1 < n && c < Skv ? ks[c] : 0;
      }
      int kmin = IMAX, kmax = IMIN;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        if (c0 + lane + 32 * j < Skv) {
          kmin = min(kmin, sv[j]);
          kmax = max(kmax, sv[j]);
        }
      }
      warp_range(kmin, kmax);
      const int kind = tile_kind<TILE>(c0, kmin, kmax, qmin, qmax, bp_lo,
                                       bp_hi, Skv, causal, window);
      if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);
      int* sg = segs + st * P::SEG_INTS;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) sg[lane + 32 * j] = sv[j];
      if (lane == 0) {
        sg[TILE] = kmin;
        sg[TILE + 1] = kmax;
      }
      const uint32_t fb = full + 8 * st;
      if (lane == 0 && kind != SKIP) {
        const uint32_t kd = kv_s + st * P::STAGE_BYTES;
        const uint32_t vd = kd + TILE_BYTES;
        mbar_expect_tx(fb, P::STAGE_BYTES);
        tma_load_4d(kd, &kmap, fb, 0, kvh, c0, b);
        tma_load_4d(kd + TILE_HALF, &kmap, fb, HALF_COLS, kvh, c0, b);
        tma_load_4d(vd, &vmap, fb, 0, kvh, c0, b);
        tma_load_4d(vd + TILE_HALF, &vmap, fb, HALF_COLS, kvh, c0, b);
      } else {
        mbar_arrive(fb);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int row_base = q0 + wg * WG_ROWS;
  const int r0 = row_base + wq * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int p0 = q_off + r0, p1 = p0 + 8;
  const int qs0 = r0 < Sq ? qseg[(long)b * Sq + r0] : 0;
  const int qs1 = r1 < Sq ? qseg[(long)b * Sq + r1] : 0;
  const int2 qr =
      wg_id_range(wg_range, wg, wq, lane, r0, qs0, qs1, Sq);
  const long stat = ((long)b * H + h) * Sq;
  const float l0 = r0 < Sq ? lse[stat + r0] * LOG2E : 0.f;
  const float l1 = r1 < Sq ? lse[stat + r1] * LOG2E : 0.f;
  const float dl0 = r0 < Sq ? delta[stat + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[stat + r1] : 0.f;
  const int p_lo = q_off + row_base;
  const int p_hi = q_off + min(row_base + WG_ROWS, Sq) - 1;
  const float slope2 = alibi_slope2(alibi, h, H);

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  const uint32_t qa = q_s + wg * WG_ROWS * 128;
  const uint32_t doa = do_s + wg * WG_ROWS * 128;
#define PROBS_ARGS                                                         \
  s, sg, c0, p0, p1, qs0, qs1, l0, l1, tig, Skv, causal, window,           \
      scale_log2, slope2
  mbar_wait(qbar, 0);

  // a tile's dQ product runs on under the next tile's S and dP: `held` is
  // its stage, released once the product has been waited (-1: none)
  int held = -1;
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    const int c0 = (t_lo + i) * TILE;
    mbar_wait(full + 8 * st, (i / STAGES) & 1);
    const int* sg = segs + st * P::SEG_INTS;
    // broadcast from lane 0: the compiler then knows the branches around
    // the wgmma instructions are warp-uniform and does not serialize them
    const int kind = __shfl_sync(
        0xffffffffu,
        tile_kind<TILE>(c0, sg[TILE], sg[TILE + 1], qr.x, qr.y, p_lo, p_hi,
                        Skv, causal, window),
        0);
    if (kind != SKIP) {
      const uint32_t kb = kv_s + st * P::STAGE_BYTES;
      const uint32_t vb = kb + TILE_BYTES;
      float s[32], dp[32];
      halva::wgmma_fence();
      product_64x64(s, qa, P::Q_HALF, kb, TILE_HALF);  // S = Q K^T
      halva::wgmma_commit();
      product_64x64(dp, doa, P::Q_HALF, vb, TILE_HALF);  // dP = dO V^T
      halva::wgmma_commit();
      halva::wgmma_wait<2>();  // the previous tile's dQ product
      if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
      halva::wgmma_wait<1>();
      if (kind == MASKED)
        alibi ? dq_probs<true, true>(PROBS_ARGS)
              : dq_probs<true, false>(PROBS_ARGS);
      else
        alibi ? dq_probs<false, true>(PROBS_ARGS)
              : dq_probs<false, false>(PROBS_ARGS);
      halva::wgmma_wait<0>();
      // dS = P (dP - delta) scale, in place of dP
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = s[e] * (dp[e] - ((e & 2) ? dl1 : dl0)) * scale;
      uint32_t da[4][4];
      pack_a(dp, da);
      halva::wgmma_fence();
      product_rs(acc, da, kb, TILE_HALF);  // dQ += dS K
      halva::wgmma_commit();
      held = st;
    } else {
      // nothing of this warp reads the stage; release the held one too, or
      // the producer could wait for it while this warp waits for a fill
      halva::wgmma_wait<0>();
      if (lane == 0) {
        if (held >= 0) mbar_arrive(empty + 8 * held);
        mbar_arrive(empty + 8 * st);
      }
      held = -1;
    }
  }
  halva::wgmma_wait<0>();
  if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
#undef PROBS_ARGS

  // dQ through this warpgroup's rows of the Q tile
  unsigned char* buf = smem + (qa - raw);
  proxy_fence();
  stage_rows(acc, buf, P::Q_HALF, wq, g, tig);
  named_sync(1 + wg, 128);
  const long q_row = (long)H * D;  // elements between sequence positions
  write_rows(buf, P::Q_HALF, dq + (long)b * Sq * q_row + (long)h * D, q_row,
             row_base, Sq);
}

// grid (KVH, B, key tiles), first key tile first. Warps as in K2.
template <int KEYS>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kvseg,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                     int KVH, float scale, float scale_log2, int causal,
                     int alibi, int window, int q_off) {
  using P = DkvPlan<KEYS>;
  constexpr int STAGES = P::STAGES;
  static_assert(KEYS == 64 || KEYS == 128, "keys a block");
  static_assert(P::SMEM <= 232448 - 1024, "shared memory of one block");
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int2 wg_range[2][4];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + P::KV_BYTES;
  const uint32_t ring = v_s + P::KV_BYTES;  // stage st: Q, then dO
  const uint32_t info_s = ring + STAGES * P::STAGE_BYTES;
  const uint32_t full = info_s + STAGES * P::INFO_INTS * 4;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t kvbar = empty + 8 * STAGES;
  int* infos = reinterpret_cast<int*>(smem + (info_s - raw));

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * KEYS;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the walk: query tiles [qt_lo, qt_hi) of each of the G heads in turn.
  // Under the causal mask local row i sits at position q_off + i and the
  // block's keys start at kv0; a query tile is wholly past the window of
  // the block's last key iff its least row - col is >= window
  const int kv_last = min(kv0 + KEYS, Skv) - 1;
  const int qt_lo = causal ? max(kv0 - q_off, 0) / TILE : 0;
  int qt_hi = (Sq + TILE - 1) / TILE;
  if (window > 0) {
    const int past = kv_last + window - q_off;
    qt_hi = min(qt_hi, past > 0 ? (past + TILE - 1) / TILE : 0);
  }
  const int per_head = max(qt_hi - qt_lo, 0);
  const int n = G * per_head;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 32);  // every producer lane
      // every consumer warp that reads the stage
      mbar_init(empty + 8 * st, P::SPLIT ? 4 : 8);
    }
    mbar_init(kvbar, 1);
    halva::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    if (warp > 8) return;
    if (lane == 0 && n > 0) {
      mbar_expect_tx(kvbar, 2 * P::KV_BYTES);
      tma_load_4d(k_s, &kmap, kvbar, 0, kvh, kv0, b);
      tma_load_4d(k_s + P::K_HALF, &kmap, kvbar, HALF_COLS, kvh, kv0, b);
      tma_load_4d(v_s, &vmap, kvbar, 0, kvh, kv0, b);
      tma_load_4d(v_s + P::K_HALF, &vmap, kvbar, HALF_COLS, kvh, kv0, b);
    }
    // the segment-id range of the block's keys below Skv
    int kmin = IMAX, kmax = IMIN;
#pragma unroll
    for (int j = 0; j < KEYS / 32; ++j) {
      const int c = kv0 + lane + 32 * j;
      if (c < Skv) {
        const int v = kvseg[(long)b * Skv + c];
        kmin = min(kmin, v);
        kmax = max(kmax, v);
      }
    }
    warp_range(kmin, kmax);
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const int h = kvh * G + i / per_head;
      const int r0 = (qt_lo + i % per_head) * TILE;
      // the tile's queries: ids, LSE * log2 e and delta (0 past Sq)
      const long stat = ((long)b * H + h) * Sq;
      int qv[TILE / 32];
      float lv[TILE / 32], dl[TILE / 32];
      int qmin = IMAX, qmax = IMIN;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        const int r = r0 + lane + 32 * j;
        const bool in = r < Sq;
        qv[j] = in ? qseg[(long)b * Sq + r] : 0;
        lv[j] = in ? lse[stat + r] * LOG2E : 0.f;
        dl[j] = in ? delta[stat + r] : 0.f;
        if (in) {
          qmin = min(qmin, qv[j]);
          qmax = max(qmax, qv[j]);
        }
      }
      warp_range(qmin, qmax);
      if (qmin > qmax) qmin = qmax = 0;
      const int kind =
          tile_kind<KEYS>(kv0, kmin, kmax, qmin, qmax, q_off + r0,
                          q_off + min(r0 + TILE, Sq) - 1, Skv, causal,
                          window);
      if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);
      int* info = infos + st * P::INFO_INTS;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        info[lane + 32 * j] = qv[j];
        info[TILE + lane + 32 * j] = __float_as_int(lv[j]);
        info[2 * TILE + lane + 32 * j] = __float_as_int(dl[j]);
      }
      if (lane == 0) {
        info[3 * TILE] = qmin;
        info[3 * TILE + 1] = qmax;
      }
      const uint32_t fb = full + 8 * st;
      if (lane == 0 && kind != SKIP) {
        const uint32_t qd = ring + st * P::STAGE_BYTES;
        const uint32_t dd = qd + TILE_BYTES;
        mbar_expect_tx(fb, P::STAGE_BYTES);
        tma_load_4d(qd, &qmap, fb, 0, h, r0, b);
        tma_load_4d(qd + TILE_HALF, &qmap, fb, HALF_COLS, h, r0, b);
        tma_load_4d(dd, &domap, fb, 0, h, r0, b);
        tma_load_4d(dd + TILE_HALF, &domap, fb, HALF_COLS, h, r0, b);
      } else {
        mbar_arrive(fb);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  // warp-uniform by construction; broadcast so that the compiler knows it
  // (the walk below runs wgmma under it)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int c0 = kv0 + (P::SPLIT ? 0 : wg * WG_ROWS);  // this warpgroup's keys
  const int k0 = c0 + wq * 16 + g, k1 = k0 + 8;        // this thread's keys
  // segment 0 past Skv: such a key matches no query
  const int ks0 = k0 < Skv ? kvseg[(long)b * Skv + k0] : 0;
  const int ks1 = k1 < Skv ? kvseg[(long)b * Skv + k1] : 0;
  const int2 kr = wg_id_range(wg_range, wg, wq, lane, k0, ks0, ks1, Skv);

  float dka[64], dva[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) dka[e] = dva[e] = 0.f;
  // A operands: this warpgroup's 64 keys of K and V
  const uint32_t ka = k_s + (P::SPLIT ? 0 : wg * WG_ROWS * 128);
  const uint32_t va = v_s + (P::SPLIT ? 0 : wg * WG_ROWS * 128);
#define PROBS_ARGS                                                         \
  s, info, pq0, k0, k1, ks0, ks1, tig, causal, window, scale_log2, slope2
  if (n > 0) mbar_wait(kvbar, 0);

  for (int i = P::SPLIT ? wg : 0; i < n; i += P::SPLIT ? 2 : 1) {
    const int st = i % STAGES;
    const int h = kvh * G + i / per_head;
    const int r0 = (qt_lo + i % per_head) * TILE;
    const int pq0 = q_off + r0;
    mbar_wait(full + 8 * st, (i / STAGES) & 1);
    const int* info = infos + st * P::INFO_INTS;
    // the tile rule with the walked query tile in the role of K1's rows
    const int kind = __shfl_sync(
        0xffffffffu,
        tile_kind<WG_ROWS>(c0, kr.x, kr.y, info[3 * TILE],
                           info[3 * TILE + 1], pq0,
                           q_off + min(r0 + TILE, Sq) - 1, Skv, causal,
                           window),
        0);
    if (kind != SKIP) {
      const float slope2 = alibi_slope2(alibi, h, H);
      const uint32_t qb = ring + st * P::STAGE_BYTES;
      const uint32_t db = qb + TILE_BYTES;
      float s[32], dp[32];
      halva::wgmma_fence();
      product_64x64(s, ka, P::K_HALF, qb, TILE_HALF);  // S^T = K Q^T
      halva::wgmma_commit();
      product_64x64(dp, va, P::K_HALF, db, TILE_HALF);  // dP^T = V dO^T
      halva::wgmma_commit();
      halva::wgmma_wait<1>();
      if (kind == MASKED)
        alibi ? dkv_probs<true, true>(PROBS_ARGS)
              : dkv_probs<true, false>(PROBS_ARGS);
      else
        alibi ? dkv_probs<false, true>(PROBS_ARGS)
              : dkv_probs<false, false>(PROBS_ARGS);
      halva::wgmma_wait<0>();
      // dS^T = P^T (dP^T - delta) scale, in place of dP^T (delta by query)
      const float* dls = reinterpret_cast<const float*>(info + 2 * TILE);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dls + 8 * j +
                                                          2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x)) * scale;
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(s, pa);
      pack_a(dp, da);
      halva::wgmma_fence();
      product_rs(dva, pa, db, TILE_HALF);  // dV += P^T dO
      product_rs(dka, da, qb, TILE_HALF);  // dK += dS^T Q
      halva::wgmma_commit();
      halva::wgmma_wait<0>();
    }
    // this warp's reads of the stage are done (its wgmma groups waited)
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
#undef PROBS_ARGS

  if (P::SPLIT) {
    // warpgroup 1's sums into the ring, once both walks are done (no copy
    // is in flight: every stage was waited), then warpgroup 0 adds them to
    // its own in a fixed order
    float* red = reinterpret_cast<float*>(smem + (ring - raw));
    const int t = threadIdx.x & 127;
    named_sync(3, 256);
    if (wg == 1) {
      proxy_fence();
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        red[e * 128 + t] = dka[e];
        red[(64 + e) * 128 + t] = dva[e];
      }
    }
    named_sync(3, 256);
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      dka[e] += red[e * 128 + t];
      dva[e] += red[(64 + e) * 128 + t];
    }
  }

  // dK and dV through this warpgroup's rows of the K and V tiles
  unsigned char* kbuf = smem + (ka - raw);
  unsigned char* vbuf = smem + (va - raw);
  proxy_fence();
  stage_rows(dka, kbuf, P::K_HALF, wq, g, tig);
  stage_rows(dva, vbuf, P::K_HALF, wq, g, tig);
  named_sync(1 + wg, 128);
  const long kv_row = (long)KVH * D;
  const long kv_off = (long)b * Skv * kv_row + (long)kvh * D;
  write_rows(kbuf, P::K_HALF, dk + kv_off, kv_row, c0, Skv);
  write_rows(vbuf, P::K_HALF, dv + kv_off, kv_row, c0, Skv);
}

bool valid_args(int B, int Sq, int Skv, int H, int KVH, int D_, int window,
                int q_off) {
  // the head dim of every supported Llama config
  return B > 0 && Sq > 0 && Skv > 0 && KVH > 0 && H % KVH == 0 && D_ == D &&
         window >= 0 && q_off >= 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Every kernel instance the plan can choose, prepared once per device at
// the first launch there: its opt-in to above 48 KB of dynamic shared
// memory, and the check that its setmaxnreg pool suffices (a shortfall
// would hang: refused instead). The first launch on a device is never
// inside a CUDA graph capture (the callers warm up first), and a later
// launch of another instance finds it done.
int prepare_device() {
  static uint64_t prepared = 0;
  static const int pools = [] {
    using halva::flash::setmaxnreg_pool_ok;
    int e = setmaxnreg_pool_ok(flash_bwd_dq_kernel, NTHREADS, 256,
                               DqPlan::CONSUMER_REGS, DqPlan::PRODUCER_REGS);
    if (!e)
      e = setmaxnreg_pool_ok(flash_bwd_dkv_kernel<128>, NTHREADS, 256,
                             DkvPlan<128>::CONSUMER_REGS,
                             DkvPlan<128>::PRODUCER_REGS);
    if (!e)
      e = setmaxnreg_pool_ok(flash_bwd_dkv_kernel<64>, NTHREADS, 256,
                             DkvPlan<64>::CONSUMER_REGS,
                             DkvPlan<64>::PRODUCER_REGS);
    return e;
  }();
  if (pools) return pools;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(prepared >> dev & 1)) {
    if ((err = set_smem(flash_bwd_dq_kernel, DqPlan::SMEM))) return err;
    if ((err = set_smem(flash_bwd_dkv_kernel<128>, DkvPlan<128>::SMEM)))
      return err;
    if ((err = set_smem(flash_bwd_dkv_kernel<64>, DkvPlan<64>::SMEM)))
      return err;
    prepared |= uint64_t(1) << dev;
  }
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout;
  const int *qseg, *kvseg;
  const float *lse, *delta;
  int B, Sq, Skv, H, KVH;
  float scale;
  int causal, alibi, window, q_off;
  cudaStream_t stream;
};

// the four tensor maps: Q and dO in boxes of q_rows positions, K and V of
// kv_rows
int encode_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap* maps) {
  using halva::flash::encode_bshd;
  int err;
  if ((err = encode_bshd(&maps[0], a.q, a.B, a.Sq, a.H, q_rows))) return err;
  if ((err = encode_bshd(&maps[1], a.k, a.B, a.Skv, a.KVH, kv_rows)))
    return err;
  if ((err = encode_bshd(&maps[2], a.v, a.B, a.Skv, a.KVH, kv_rows)))
    return err;
  return encode_bshd(&maps[3], a.dout, a.B, a.Sq, a.H, q_rows);
}

int launch_dq(const Args& a, __nv_bfloat16* dq) {
  CUtensorMap m[4];
  int err = encode_maps(a, DqPlan::BQ, TILE, m);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.Sq + DqPlan::BQ - 1) / DqPlan::BQ);
  flash_bwd_dq_kernel<<<grid, NTHREADS, DqPlan::SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], a.qseg, a.kvseg, a.lse, a.delta, dq, a.Sq,
      a.Skv, a.H, a.KVH, a.scale, a.scale * LOG2E, a.causal, a.alibi,
      a.window, a.q_off);
  return (int)cudaGetLastError();
}

template <int KEYS>
int launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv) {
  CUtensorMap m[4];
  int err = encode_maps(a, TILE, KEYS, m);
  if (err) return err;
  const dim3 grid(a.KVH, a.B, (a.Skv + KEYS - 1) / KEYS);
  flash_bwd_dkv_kernel<KEYS>
      <<<grid, NTHREADS, DkvPlan<KEYS>::SMEM, a.stream>>>(
          m[0], m[1], m[2], m[3], a.qseg, a.kvseg, a.lse, a.delta, dk, dv,
          a.Sq, a.Skv, a.H, a.KVH, a.scale, a.scale * LOG2E, a.causal,
          a.alibi, a.window, a.q_off);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout (B, Sq, H, D), k/v (B, Skv, KVH, D) bf16, 16-byte aligned; qseg
// (B, Sq), kvseg (B, Skv) int32; lse, delta (B, H, Sq) fp32; dq (B, Sq, H, D)
// bf16. alibi 0 | 1, window 0 = none, q_off >= 0, as K1 was given them; bk:
// keys per tile, 64 (the plan's). Returns a cudaError_t.
extern "C" int halva_flash_bwd_dq_bf16(const void* q, const void* k,
                                       const void* v, const void* qseg,
                                       const void* kvseg, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int B, int Sq, int Skv,
                                       int H, int KVH, int D_, float scale,
                                       int causal, int alibi, int window,
                                       int q_off, int bk, void* stream) {
  if (!valid_args(B, Sq, Skv, H, KVH, D_, window, q_off) || bk != TILE)
    return (int)cudaErrorInvalidValue;
  const int err = prepare_device();
  if (err) return err;
  const Args a{q, k, v, dout,
               static_cast<const int*>(qseg), static_cast<const int*>(kvseg),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, Sq, Skv, H, KVH, scale, causal, alibi, window, q_off,
               static_cast<cudaStream_t>(stream)};
  return launch_dq(a, static_cast<__nv_bfloat16*>(dq));
}

// As above; dk, dv (B, Skv, KVH, D) bf16, summed over each kv head's group;
// keys: keys per block, 128 or 64 (the plan's layout).
extern "C" int halva_flash_bwd_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* qseg,
                                        const void* kvseg, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int Sq,
                                        int Skv, int H, int KVH, int D_,
                                        float scale, int causal, int alibi,
                                        int window, int q_off, int keys,
                                        void* stream) {
  if (!valid_args(B, Sq, Skv, H, KVH, D_, window, q_off) ||
      (keys != 128 && keys != 64))
    return (int)cudaErrorInvalidValue;
  const int err = prepare_device();
  if (err) return err;
  const Args a{q, k, v, dout,
               static_cast<const int*>(qseg), static_cast<const int*>(kvseg),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, Sq, Skv, H, KVH, scale, causal, alibi, window, q_off,
               static_cast<cudaStream_t>(stream)};
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  return keys == 128 ? launch_dkv<128>(a, dkp, dvp)
                     : launch_dkv<64>(a, dkp, dvp);
}
