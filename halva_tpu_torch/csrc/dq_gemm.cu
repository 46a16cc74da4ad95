// K7 and K8: M-tiled GEMMs over quantized weights, y (M, N) = x (M, K) @ W,
// with W dequantized on the way from shared memory to the tensor cores.
//
// K7 (w4_gemm) replaces the Pallas TPU kernel halva_tpu/ops/w4_matmul.py:
// _w4_kernel as launched by _w4_gemm_impl (the M-blocked form of K6):
//   y[m, j]       = sum_k x[m, k] * lo(w[k, j]) * s[0, k / gs, j]
//   y[m, j + N/2] = sum_k x[m, k] * hi(w[k, j]) * s[1, k / gs, j]
// w is kernel_q4p (K, N/2) int8, split-half packed: byte [k, j] holds channel
// j in its low nibble and channel j + N/2 in its high nibble, two's
// complement in [-8, 7]; s is kernel_scale4p (2, G, N/2) bf16, gs = K / G.
// K8 (int8_matmul) replaces halva_tpu/ops/int8_matmul.py:_kernel:
//   y[m, n] = (sum_k x[m, k] * q[k, n]) * s[n],  q (K, N) int8, s (N) bf16.
// x and y are bf16, sums fp32.
//
// Rounding. K8 and K7 with G = 1 multiply the fp32 sum by the scale at the
// end, as the Pallas kernels do. K7 with G > 1 scales the converted weights:
// nibble (exact in bf16) times scale, rounded to bf16 (one __hmul2), then
// the tensor-core product: the order and the rounding of the Pallas kernel,
// which computes nibble * scale in fp32 (exact) and rounds it to bf16; so
// does the plain version. A K tile (64 rows) lies in one scale group, so gs
// must be a multiple of 64.
//
// Conversion, on both paths: int4 by the magic number (nibble ^ 8 ored into
// the mantissa of bf16 128.0, minus 136.0, two values per __hsub2; no I2F),
// int8 through the mantissa of fp32 2^23. K does not stay whole per block
// (the TPU kernel holds (K, bnp) in VMEM): a block walks K in tiles of 64
// rows through a ring of stages. Where the output tiles leave SMs idle, K is
// split across blocks (the plan is the Python wrapper's, ops/int8_matmul.py:
// gemm_plan); each split writes its fp32 partial tile and the last block of
// a tile to finish (a ticket taken with atomicAdd after a __threadfence)
// sums the partials in split order, scales and writes y: deterministic, one
// launch, no float atomics. It resets its ticket.
//
// Two paths, chosen by the plan.
//   - Up to 32 rows (decode-family M, bound by the weight bytes: every
//     packed byte is read once for all rows): the loop of csrc/dq_rows.cuh,
//     shared with K6. The weights are mma.sync's A operand, converted in
//     registers straight from the raw tile (no bf16 tile, no block barrier
//     in the loop), x^T its B operand in chunks of 8, 16 or 32 rows; each
//     of a block's four warps streams its quarter of the K split through
//     its own ring of cp.async stages. Also every launch whose weight rows
//     are not a multiple of 16 bytes (TMA's stride rule), at any M, in
//     32-row chunks.
//   - Above 32 rows (K7 at batch 80, K8 at prefill and tower rows): 128 rows
//     x 256 channels, warp specialised. Stamped with clock64, the old
//     128-row loop spent a K tile (~2.1 us) on the copy issue, the
//     conversion and the mma.sync issue one after another on the same eight
//     warps, waiting for no copy (scripts/dq_gemm_phases.py). Here one
//     producer warp (registers lowered by setmaxnreg) keeps TMA loads of the
//     x tile (128-byte swizzle: rows past M arrive as zeros, no copy issued)
//     and the raw tile (and, for K7 with G > 1, the tile's group of scales)
//     in flight in a ring of 5 (int8) or 6 (int4) stages, each with a full
//     and an empty mbarrier. Two consumer warpgroups own 128 channels each
//     (K7: the low and the high nibbles of the same 128 packed columns);
//     each converts its half of the raw tile, 16 bytes a store, into its
//     own bf16 tile in wgmma's 128-byte-swizzled N-major layout (two
//     buffers), then issues wgmma m64n128k16 with A = the x tile (K-major)
//     and B = that tile (trans-b), one group in flight: converting tile i+1
//     overlaps the tensor work on tile i, and no barrier spans the two
//     warpgroups. A block whose second 64 rows lie past M issues one m64
//     tile, not two. The fp32 sums stay in registers; the epilogue scales
//     (K8, K7 G = 1) and stores bf16 rows below M. A split plan's last
//     block reads the partials back through TMA (a third tensor map) in
//     units of 32 rows x 256 channels, six in flight in the freed ring:
//     summed with per-thread loads, one SM was bound by the loads it could
//     keep in flight. Tensor maps are encoded on the host per launch
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: the library
//     needs no -lcuda) and passed as __grid_constant__ parameters. What
//     bounds a tile now is its conversion, which shares shared memory with
//     the wgmma operand reads; at 80 rows the 128-row tile also computes 48
//     rows of zeros (scripts/dq_gemm_phases.py stamps both loops).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py
// --gemm-only; more in PERF.md section 6): K8 gate/up (4096 x 11008) at
// 2,492 rows 0.48 ms, dequantize + torch.matmul 0.54, the 128-row mma.sync
// loop before 0.96; K7 g=128 at 80 rows 0.029 / 0.041 / 0.044 ms for wq /
// gate/up / down (before: 0.045 / 0.074 / 0.077), 5-10x their byte bounds.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_rows.cuh"
#include "hopper_common.cuh"
#include "mma_bf16.cuh"

namespace {

using halva::encode;
using halva::mbar_arrive;
using halva::mbar_expect_tx;
using halva::mbar_init;
using halva::mbar_wait;
using halva::named_sync;
using halva::smem_u32;
using halva::sw128_desc;
using halva::tma_load_2d;
using halva::tma_load_3d;
using halva::pack_bf16;

constexpr int BK = 64;  // K rows per tile of the wgmma path and the plan

enum Mode { W8 = 0, W4_CHANNEL = 1, W4_GROUPED = 2 };

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// byte i of w (already xored with 0x80) as a float in [-128, 127]: the byte
// becomes the low mantissa bits of 2^23, minus 2^23 + 128
__device__ __forceinline__ float s8_to_float(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

// ---------------------------------------------------------------------------
// Above SMALL_M rows: TMA loads, a producer warp, wgmma on the converted tile.

constexpr int WS_BM = 128;        // rows per block: two m64 wgmma tiles
constexpr int WS_BN = 256;        // output channels per block
constexpr int WS_CH = 128;        // channels of one consumer warpgroup
constexpr int WS_THREADS = 288;   // two consumer warpgroups + the producer warp
constexpr int WS_X_BYTES = WS_BM * BK * 2;    // one bf16 x tile, 16 KB
constexpr int WS_CONV_BYTES = BK * WS_CH * 2;  // one converted tile, 16 KB
constexpr int WS_ATOM_BYTES = BK * 128;  // 64 channels x 64 K rows of it
constexpr int WS_SUM_ROWS = 32;  // rows of a unit of the split sum
constexpr int WS_SUM_BYTES = WS_SUM_ROWS * WS_BN * 4;  // fp32, 32 KB
constexpr int WS_SUM_BUFS = 6;  // units of it in flight

template <int MODE>
struct WsShape {
  static constexpr int RAWB = MODE == W8 ? WS_BN : WS_BN / 2;  // bytes/K row
  static constexpr int RAW_BYTES = BK * RAWB;
  // K7 with G > 1: a stage also holds the scales of its group, both halves
  static constexpr int SCALE_BYTES = MODE == W4_GROUPED ? 2 * 128 * 2 : 0;
  static constexpr int STAGES = MODE == W8 ? 5 : 6;
  static constexpr int STAGE_BYTES = WS_X_BYTES + RAW_BYTES + SCALE_BYTES;
  // 1 KB of slack to align the swizzled tiles to 1024 bytes
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES +
                              4 * WS_CONV_BYTES +
                              (2 * STAGES + WS_SUM_BUFS) * 8;
  // the split sum's buffers of 64 partial rows x 256 channels (fp32) reuse
  // the x, converted and raw tiles
  static_assert(STAGES * STAGE_BYTES + 4 * WS_CONV_BYTES >=
                    WS_SUM_BUFS * WS_SUM_BYTES,
                "split-sum buffers");
};
// a block's shared memory: 227 KB less the 1 KB of static shared memory
// the 1024-byte alignment costs
static_assert(WsShape<W8>::SMEM <= 232448 - 1024 &&
              WsShape<W4_GROUPED>::SMEM <= 232448 - 1024,
              "shared memory of one block");

// 8 raw int4 values of one nibble half (`shift` 0: low, 4: high) of the
// packed words v0, v1 (biased by the xor with 0x88888888) as 8 bf16: value
// + 8 or-ed into the mantissa of bf16 128.0, minus 136.0, two per __hsub2;
// times the group's scales (pairs (0, 2), (1, 3) of each word) if GROUPED
template <bool GROUPED>
__device__ __forceinline__ uint4 int4x8_to_bf16(uint32_t v0, uint32_t v1,
                                                int shift, uint4 sc) {
  constexpr uint32_t MASK = 0x000F000Fu, ONE28 = 0x43004300u;
  constexpr uint32_t BIAS = 0x43084308u;  // bf16 136.0 twice
  uint32_t out[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u = (h ? v1 : v0) >> shift;
    uint32_t v02 = bf2_sub((u & MASK) | ONE28, BIAS);
    uint32_t v13 = bf2_sub(((u >> 8) & MASK) | ONE28, BIAS);
    if (GROUPED) {
      const uint32_t lo = h ? sc.z : sc.x, hi = h ? sc.w : sc.y;
      v02 = bf2_mul(v02, __byte_perm(lo, hi, 0x5410));
      v13 = bf2_mul(v13, __byte_perm(lo, hi, 0x7632));
    }
    out[2 * h] = __byte_perm(v02, v13, 0x5410);
    out[2 * h + 1] = __byte_perm(v02, v13, 0x7632);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// 8 int8 values (biased by the xor with 0x80808080) as 8 bf16
__device__ __forceinline__ uint4 int8x8_to_bf16(uint32_t v0, uint32_t v1) {
  return make_uint4(
      pack_bf16(s8_to_float(v0, 0x7440), s8_to_float(v0, 0x7441)),
      pack_bf16(s8_to_float(v0, 0x7442), s8_to_float(v0, 0x7443)),
      pack_bf16(s8_to_float(v1, 0x7440), s8_to_float(v1, 0x7441)),
      pack_bf16(s8_to_float(v1, 0x7442), s8_to_float(v1, 0x7443)));
}

// One consumer warpgroup (128 threads, `wg` 0 or 1) of a block: MT m64 tiles
// (1 when the block's second 64 rows are all past M) by this warpgroup's 128
// channels. It waits for a stage, converts its half of the raw tile into its
// own bf16 tile, waits for its previous wgmma group, and issues the next:
// converting tile i+1 overlaps the tensor work on tile i. Then the epilogue.
template <int MODE, int MT>
__device__ __forceinline__ void ws_consume(
    int wg, uint32_t xs, uint32_t cs, const unsigned char* raw,
    const unsigned char* scales, uint32_t bars, const CUtensorMap* pmap,
    const __nv_bfloat16* __restrict__ s,
    __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
    int* __restrict__ tickets, int* is_last, int M, int K, int N, int G,
    int splits, int kt0, int nkt) {
  using S = WsShape<MODE>;
  constexpr bool W4 = MODE != W8;
  const int wtid = threadIdx.x & 127, lane = threadIdx.x & 31;
  // this thread converts 8 bytes (K8: 8 channels; K7: 8 packed columns, of
  // which warpgroup 0 takes the low nibbles and 1 the high) of K rows
  // rw + 8 j into 16 bytes of its warpgroup's tile: 64-channel atom
  // wc / 8, 16-byte chunk (wc % 8) xor (r % 8) (the 128-byte swizzle)
  const int wc = wtid & 15;
  const int rw = wtid >> 4;
  const int LD = W4 ? N / 2 : N;
  const int c0 = blockIdx.x * S::RAWB;
  const int m0 = blockIdx.y * WS_BM;
  const uint32_t full = bars, empty = bars + 8 * S::STAGES;
  const int dst0 = (wc >> 3) * WS_ATOM_BYTES;
  const int chunk = wc & 7;
  const int pair = MODE == W8 ? wg * 16 + wc : wc;  // raw 8-byte column
  const int shift = wg * 4;


  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[mt][e] = 0.f;

  for (int i = 0; i < nkt; ++i) {
    const int st = i % S::STAGES;
    mbar_wait(full + 8 * st, (i / S::STAGES) & 1);
    // K7 with G > 1: the 8 scales of this thread's channels, of its half
    const uint4 sc =
        MODE == W4_GROUPED
            ? *reinterpret_cast<const uint4*>(
                  scales + st * S::SCALE_BYTES + (wg * 128 + 8 * wc) * 2)
            : make_uint4(0u, 0u, 0u, 0u);
    const uint2* wr = reinterpret_cast<const uint2*>(raw + st * S::RAW_BYTES);
    unsigned char* cv = reinterpret_cast<unsigned char*>(
        __cvta_shared_to_generic(cs + (i & 1) * WS_CONV_BYTES));
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int r = rw + 8 * j;
      const uint2 v = wr[r * (S::RAWB / 8) + pair];
      const uint4 out =
          W4 ? int4x8_to_bf16<MODE == W4_GROUPED>(
                   v.x ^ 0x88888888u, v.y ^ 0x88888888u, shift, sc)
             : int8x8_to_bf16(v.x ^ 0x80808080u, v.y ^ 0x80808080u);
      *reinterpret_cast<uint4*>(cv + dst0 + r * 128 +
                                ((chunk ^ (r & 7)) << 4)) = out;
    }
    // the converted tile is read by wgmma (the async proxy); the previous
    // group is done on every warp of the warpgroup once it passes the
    // barrier, so that group's x stage is released and the converted tile
    // it read is free for tile i + 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    named_sync(1 + wg, 128);
    if (i > 0 && wtid == 0) mbar_arrive(empty + 8 * ((i - 1) % S::STAGES));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t xa = xs + st * WS_X_BYTES;
    const uint32_t cb = cs + (i & 1) * WS_CONV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B: 16 K rows (two 8-row groups, SBO apart) by two 64-channel atoms
      // (LBO apart); A: 32 bytes further along each 128-byte x row
      const uint64_t db = sw128_desc(cb + kk * 16 * 128, WS_ATOM_BYTES, 1024);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        halva::wgmma_m64n128_ss<1>(
            acc[mt], sw128_desc(xa + mt * 64 * 128 + kk * 32, 16, 1024), db,
            1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // fragment e of an m64n128 tile: row 16 (warp % 4) + lane / 4 + 8 ((e / 2)
  // % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2 of the warpgroup's channels
  const int row0 = m0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  // output channel of column c of this warpgroup's 128 (false past the edge)
  auto channel = [&](int c, int& n) {
    if (W4) {
      n = wg * LD + c0 + c;
      return c0 + c < LD;
    }
    n = c0 + wg * WS_CH + c;
    return n < N;
  };
  auto scale_of = [&](int n) {
    return MODE == W4_GROUPED ? 1.f : __bfloat162float(s[n]);
  };

  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int n;
      if (!channel(8 * j + col0, n)) continue;
      const float s0 = scale_of(n), s1 = scale_of(n + 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 64 * mt + 8 * h;
          if (r < M)
            *reinterpret_cast<uint32_t*>(y + (long)r * N + n) =
                pack_bf16(acc[mt][4 * j + 2 * h] * s0,
                          acc[mt][4 * j + 2 * h + 1] * s1);
        }
    }
    return;
  }

  float* mine = partial + (long)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int n;
    if (!channel(8 * j + col0, n)) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 64 * mt + 8 * h;
        if (r < M)
          *reinterpret_cast<float2*>(mine + (long)r * N + n) = make_float2(
              acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
      }
  }
  __threadfence();  // this block's partials reach L2 before its ticket
  named_sync(3, 2 * 128);
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    *is_last = atomicAdd(&tickets[tile], 1) == splits - 1;
  named_sync(3, 2 * 128);
  if (!*is_last) return;
  if (threadIdx.x == 0) tickets[tile] = 0;  // every block has taken its own
  // The last block sums the partials in split order, whichever block it is.
  // TMA brings them into shared memory (the ring and the converted tiles
  // are free now) in units of 32 rows x 256 channels, one split at a time,
  // WS_SUM_BUFS units in flight; a unit all past M is skipped, and rows
  // past M in the others arrive as zeros and cost no bytes. Warp w of the
  // 8 sums row-segments q * 8 + w of a unit (row (q * 8 + w) / 2, channel
  // half w % 2), 4 channels a lane, and stores rows below M.
  const uint32_t sbars = bars + 16 * WsShape<MODE>::STAGES;
  // every split of rows 0-31, then of 32-63, ... up to the last row below M
  const int units =
      (min(M - m0, 64 * MT) + WS_SUM_ROWS - 1) / WS_SUM_ROWS * splits;
  auto load_unit = [&](int u) {
    const int b = u % WS_SUM_BUFS;
    const uint32_t buf = xs + b * WS_SUM_BYTES, bar = sbars + 8 * b;
    mbar_expect_tx(bar, WS_SUM_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_3d(buf + h * (WS_SUM_BYTES / 2), pmap, bar,
                  W4 ? h * LD + c0 : c0 + h * WS_CH,
                  m0 + WS_SUM_ROWS * (u / splits), u % splits);
  };
  if (threadIdx.x == 0) {
    // the other blocks' partials were written through the generic proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int u = 0; u < WS_SUM_BUFS && u < units; ++u) load_unit(u);
  }
  const int cw = threadIdx.x >> 5;
  const int half = cw & 1;
  const int n = W4 ? half * LD + c0 + 4 * lane : c0 + half * WS_CH + 4 * lane;
  const bool live = W4 ? c0 + 4 * lane < LD : n < N;
  float sv[4] = {1.f, 1.f, 1.f, 1.f};
  if (MODE != W4_GROUPED && live) {
    const uint2 v = *reinterpret_cast<const uint2*>(s + n);
    sv[0] = __uint_as_float(v.x << 16);
    sv[1] = __uint_as_float(v.x & 0xFFFF0000u);
    sv[2] = __uint_as_float(v.y << 16);
    sv[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
  constexpr int Q = WS_SUM_ROWS * 2 / 8;  // row-segments of a unit per warp
  float4 sum[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int u = 0; u < units; ++u) {
    mbar_wait(sbars + 8 * (u % WS_SUM_BUFS), (u / WS_SUM_BUFS) & 1);
    const float4* b = reinterpret_cast<const float4*>(__cvta_shared_to_generic(
        xs + (u % WS_SUM_BUFS) * WS_SUM_BYTES + half * (WS_SUM_BYTES / 2)));
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 p = b[((q * 8 + cw) >> 1) * 32 + lane];
      sum[q].x += p.x;
      sum[q].y += p.y;
      sum[q].z += p.z;
      sum[q].w += p.w;
    }
    named_sync(3, 2 * 128);  // buffer u % WS_SUM_BUFS is read
    if (threadIdx.x == 0 && u + WS_SUM_BUFS < units)
      load_unit(u + WS_SUM_BUFS);
    if (u % splits != splits - 1) continue;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = m0 + WS_SUM_ROWS * (u / splits) + ((q * 8 + cw) >> 1);
      if (live && r < M)
        *reinterpret_cast<uint2*>(y + (long)r * N + n) =
            make_uint2(pack_bf16(sum[q].x * sv[0], sum[q].y * sv[1]),
                       pack_bf16(sum[q].z * sv[2], sum[q].w * sv[3]));
      sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// grid (channel tiles of WS_BN, row tiles of WS_BM, K splits). Warps 0-7 are
// the two consumer warpgroups; warp 8 the producer: one thread keeps the TMA
// loads of the x tile (128-byte swizzle, the wgmma A layout) and the raw
// weight tile in flight, STAGES ahead, each stage with a full and an empty
// mbarrier.
template <int MODE>
__global__ void __launch_bounds__(WS_THREADS, 1)
dq_gemm_ws_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap pmap,
                  const __grid_constant__ CUtensorMap smap,
                  const __nv_bfloat16* __restrict__ s,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                  int* __restrict__ tickets, int M, int K, int N, int G,
                  int splits, int tps) {
  using S = WsShape<MODE>;
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  __shared__ int is_last;
  const uint32_t raw_base = smem_u32(ws_smem);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  const uint32_t xs = base;  // STAGES x tiles
  const uint32_t cs = xs + S::STAGES * WS_X_BYTES;  // 2 x 2 converted tiles
  const uint32_t rs = cs + 4 * WS_CONV_BYTES;  // STAGES raw weight tiles
  const uint32_t ss = rs + S::STAGES * S::RAW_BYTES;  // STAGES scale tiles
  // full, empty, then the split sum's
  const uint32_t bars = ss + S::STAGES * S::SCALE_BYTES;
  const int warp = threadIdx.x >> 5;
  const int kt0 = blockIdx.z * tps;
  const int nkt = min(K / BK, kt0 + tps) - kt0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S::STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);                   // the producer's arrival
      mbar_init(bars + 8 * (S::STAGES + st), 2);     // one per warpgroup
    }
    for (int b = 0; b < WS_SUM_BUFS; ++b)
      mbar_init(bars + 16 * S::STAGES + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if ((threadIdx.x & 31) == 0) {
      const int m0 = blockIdx.y * WS_BM, c0 = blockIdx.x * S::RAWB;
      for (int i = 0; i < nkt; ++i) {
        const int st = i % S::STAGES;
        if (i >= S::STAGES)
          mbar_wait(bars + 8 * (S::STAGES + st), (i / S::STAGES - 1) & 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, S::STAGE_BYTES);
        const int k0 = (kt0 + i) * BK;
        tma_load_2d(xs + st * WS_X_BYTES, &xmap, full, k0, m0);
        tma_load_2d(rs + st * S::RAW_BYTES, &wmap, full, c0, k0);
        if (MODE == W4_GROUPED)  // a K tile lies in one group of K / G rows
          tma_load_3d(ss + st * S::SCALE_BYTES, &smap, full, c0,
                      k0 / (K / G), 0);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  const unsigned char* raw = ws_smem + (rs - raw_base);
  const unsigned char* scales = ws_smem + (ss - raw_base);
  const uint32_t mine = cs + wg * 2 * WS_CONV_BYTES;
  if (blockIdx.y * WS_BM + 64 < M)
    ws_consume<MODE, 2>(wg, xs, mine, raw, scales, bars, &pmap, s, y,
                        partial, tickets,
                        &is_last, M, K, N, G, splits, kt0, nkt);
  else
    ws_consume<MODE, 1>(wg, xs, mine, raw, scales, bars, &pmap, s, y,
                        partial, tickets,
                        &is_last, M, K, N, G, splits, kt0, nkt);
}

template <int MODE>
int launch_ws(cudaStream_t st, const __nv_bfloat16* x, const uint8_t* w,
              const __nv_bfloat16* s, __nv_bfloat16* y, float* partial,
              int* tickets, int M, int K, int N, int G, int splits, int tps) {
  using S = WsShape<MODE>;
  static uint64_t smem_set = 0;
  auto kernel = dq_gemm_ws_kernel<MODE>;
  const int ld = MODE == W8 ? N : N / 2;
  // x (M, K) bf16 in 128-row x 64 boxes, swizzled for wgmma; w (K, ld)
  // bytes in 64 x RAWB boxes; the partials (splits, M, N) fp32 in 64-row x
  // 128-channel boxes, encoded only for a split plan
  CUtensorMap xmap, wmap, pmap = {};
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {BK, WS_BM};
  int err = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xdims,
                   xstride, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)ld, (cuuint64_t)K};
  const cuuint64_t wstride[1] = {(cuuint64_t)ld};
  const cuuint32_t wbox[2] = {S::RAWB, BK};
  err = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, wdims, wstride,
               wbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  CUtensorMap smap = {};
  if (MODE == W4_GROUPED) {  // s (2, G, ld) bf16 in boxes of 2 x 1 x 128
    const cuuint64_t sdims[3] = {(cuuint64_t)ld, (cuuint64_t)G, 2};
    const cuuint64_t sstride[2] = {(cuuint64_t)ld * 2, (cuuint64_t)G * ld * 2};
    const cuuint32_t sbox[3] = {128, 1, 2};
    err = encode(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s, 3, sdims,
                 sstride, sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  if (splits > 1) {
    const cuuint64_t pdims[3] = {(cuuint64_t)N, (cuuint64_t)M,
                                 (cuuint64_t)splits};
    const cuuint64_t pstride[2] = {(cuuint64_t)N * 4, (cuuint64_t)M * N * 4};
    const cuuint32_t pbox[3] = {WS_CH, WS_SUM_ROWS, 1};
    err = encode(&pmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, partial, 3, pdims,
                 pstride, pbox, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(smem_set >> dev & 1)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set |= uint64_t(1) << dev;
  }
  const dim3 grid((N + WS_BN - 1) / WS_BN, (M + WS_BM - 1) / WS_BM, splits);
  kernel<<<grid, WS_THREADS, S::SMEM, st>>>(xmap, wmap, pmap, smap, s, y,
                                            partial, tickets, M, K, N, G,
                                            splits, tps);
  return (int)cudaGetLastError();
}

// The two paths: up to 32 rows a block on the loop of csrc/dq_rows.cuh
// (mma.sync; 64 weight bytes a row per block, rows in chunks of bm = 8, 16
// or 32; the plan's K tiles of 64 rows are two of its 32-row tiles), and
// 128 rows x 256 channels (TMA + wgmma).
template <int MODE>
int launch_mode(int bm, cudaStream_t st, const __nv_bfloat16* x,
                const uint8_t* w, const __nv_bfloat16* s, __nv_bfloat16* y,
                float* partial, int* tickets, int M, int K, int N, int G,
                int splits, int tps) {
  if (bm == 8 || bm == 16 || bm == 32) {
    halva_rows::Args a;
    a.x = x;
    a.w = w;
    a.s = s;
    a.y = y;
    a.partial = partial;
    a.tickets = tickets;
    a.M = M;
    a.K = K;
    a.ldx = K;
    a.ld = MODE == W8 ? N : N / 2;
    a.N = N;
    a.G = G;
    a.splits = splits;
    a.tps = tps * (BK / halva_rows::BK);
    a.w16 = a.ld % 16 == 0;
    a.tpg = (K / G) / halva_rows::BK;
    constexpr int RMODE = MODE == W8           ? halva_rows::W8
                          : MODE == W4_CHANNEL ? halva_rows::W4_CHANNEL
                                               : halva_rows::W4_GROUPED;
    return halva_rows::launch_rows_mode<RMODE>(bm, a, st);
  }
  if (bm == WS_BM)
    return launch_ws<MODE>(st, x, w, s, y, partial, tickets, M, K, N, G,
                           splits, tps);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode 0: K8, w (K, N) int8, s (N) bf16. mode 1: K7, w (K, N/2) int8 packed,
// s (2, G, N/2) bf16 with G scale groups along K (G = 1: per channel).
// x (M, K) bf16; y (M, N) bf16; partial (splits, M, N) fp32 scratch (unused
// when splits == 1); tickets: >= (column tiles) * ceil(M/bm) zeroed int32.
// bm is the row tile and picks the path: 8, 16 or 32 (csrc/dq_rows.cuh,
// column tiles of 64 weight bytes) or 128 (TMA + wgmma, column tiles of 256
// channels; it needs the weights' row of N (K8) or N/2 (K7) bytes to be a
// multiple of 16). splits * tps covers the K/64 tiles of K with no empty
// split. Returns a cudaError_t.
extern "C" int halva_dq_gemm(int mode, const void* x, const void* w,
                             const void* s, void* y, void* partial,
                             void* tickets, int M, int K, int N, int G,
                             int bm, int splits, int tps, void* stream) {
  const int kt = K / BK;
  if (M <= 0 || K <= 0 || N <= 0 || K % BK != 0 || G <= 0 || K % G != 0 ||
      splits <= 0 || tps <= 0 || (long)splits * tps < kt ||
      (long)(splits - 1) * tps >= kt)
    return (int)cudaErrorInvalidValue;
  if (mode == 0 ? (N % 8 != 0 || G != 1)
                : (mode != 1 || N % 16 != 0 || (G > 1 && (K / G) % BK != 0)))
    return (int)cudaErrorInvalidValue;
  if (bm == WS_BM && (mode == 0 ? N : N / 2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  auto* tp = static_cast<int*>(tickets);
  if (mode == 0)
    return launch_mode<W8>(bm, st, xp, wp, sp, yp, pp, tp, M, K, N, G,
                           splits, tps);
  if (G == 1)
    return launch_mode<W4_CHANNEL>(bm, st, xp, wp, sp, yp, pp, tp, M, K,
                                   N, G, splits, tps);
  return launch_mode<W4_GROUPED>(bm, st, xp, wp, sp, yp, pp, tp, M, K,
                                 N, G, splits, tps);
}
