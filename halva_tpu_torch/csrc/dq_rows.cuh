// The decode-row loop of the quantized matmuls: y (M, N) = x (M, K) @ W at
// up to 32 rows a block, shared by K6 (w4_gemv.cu: packed int4, any scale
// groups) and the up-to-32-row path of K7 and K8 (dq_gemm.cu: packed int4,
// int8). What it computes:
//   W4: y[m, j]        = sum_k x[m, k] * lo(w[k, j]) * s[0, k / gs, j]
//       y[m, j + N/2]  = sum_k x[m, k] * hi(w[k, j]) * s[1, k / gs, j]
//       w (K, N/2) int8, split-half packed (low nibble channel j, high
//       nibble channel j + N/2, two's complement); s (2, G, N/2) bf16.
//   W8: y[m, n] = (sum_k x[m, k] * q[k, n]) * s[n],  q (K, N) int8.
// x and y bf16, sums fp32. Per-channel scales (G = 1, and W8) multiply the
// fp32 sum at the end; grouped scales multiply the converted bf16 weights
// (one __hmul2 per pair): nibble * scale rounded to bf16, the Pallas
// kernel's rounding.
//
// What bounds it on an H100: the weight bytes (K x N/2 for int4, 22.5 MB
// for the 7B gate/up, 7.0 us at 3.35 TB/s); x is a few KB. The design:
//   - Weights are the A operand of mma.sync m16n8k16 (16 output channels x
//     16 k) and x^T the B operand (16 k x 8 rows): up to 8 rows fill n8,
//     9-32 rows are 2-4 n8 tiles; one mma per 256 weights, fp32 sums.
//   - Conversion without I2F: int4 by the magic number (nibble ^ 8 ored
//     into the mantissa of bf16 128.0, minus 136.0, two values per
//     __hsub2); int8 through the mantissa of fp32 2^23 and one cvt to a
//     bf16 pair. An A register holds two k of one channel: one byte_perm of
//     the words of rows k and k + 1 makes the pairs of two channels, both
//     nibble halves.
//   - A block is 4 warps on one tile of 64 weight bytes a row (128 int4 or
//     64 int8 channels) and one K split; warp w takes the w-th
//     share of the split's 32-row K tiles and streams them through its own
//     ring of shared-memory stages by 16-byte cp.async (8-byte where a
//     weight row is no multiple of 16 bytes): raw weight tile, x tile and,
//     for grouped scales, the tile's group of scales. No block barrier in
//     the loop: a warp waits for its own copies (cp.async.wait_group,
//     __syncwarp).
//   - The warps' sums meet in shared memory in warp order; a K split
//     writes its fp32 partial tile and the last block of a tile to finish
//     (a ticket taken with atomicAdd after a __threadfence) sums the
//     partials in split order and writes y: deterministic, one launch, no
//     float atomics. It resets its ticket.
// The plan (ops/w4_matmul.plan for K6, ops/int8_matmul.gemm_plan for K7
// and K8) splits K so that tiles x row chunks x splits come to about two
// blocks an SM, one wave: fewer, longer warps measured faster than a grid
// that fills every block an SM holds.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py; more in
// PERF.md section 6): K6 gate/up 4096 x 11008 at B=4, g=128, 0.017 ms, 2.4x
// its byte bound (the loop it replaces: 0.040); stamped with clock64
// (scripts/w4_gemv_phases.py), a K tile waits little for its copies and
// takes as long without its mma.sync: the conversion's issue bounds it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace halva_rows {

constexpr int BK = 32;          // K rows per tile
constexpr int TW = 64;          // weight bytes a row of a block's tile
constexpr int RS = TW + 16;     // shared row stride of the raw tile (bytes)
constexpr int XS = 2 * BK + 16;  // shared row stride of the x tile (bytes)

// W4_ODD: grouped scales whose groups are no multiple of BK rows (a K tile
// spans groups): each weight pair's scales come from device memory
enum Mode { W8 = 0, W4_CHANNEL = 1, W4_GROUPED = 2, W4_ODD = 3 };

struct Args {
  const __nv_bfloat16* x;  // (M, ldx), zeros past K
  const uint8_t* w;        // (K, ld) bytes
  const __nv_bfloat16* s;
  __nv_bfloat16* y;        // (M, N)
  float* partial;          // (splits, M, N) fp32, unused when splits == 1
  int* tickets;
  int M, K, ldx, ld, N, G, splits, tps;  // tps: BK-row tiles per split
  int w16;  // ld % 16 == 0: 16-byte weight copies
  int tpg;  // W4_GROUPED: K tiles a scale group
};

template <int NT8, int MODE>
struct Shape {
  static constexpr bool W4 = MODE != W8;
  static constexpr int H = W4 ? 2 : 1;  // nibble halves
  static constexpr int ROWS = 8 * NT8;
  static constexpr int RAW = BK * RS;
  static constexpr int XB = ROWS * XS;
  static constexpr int SB = MODE == W4_GROUPED ? 2 * TW * 2 : 0;
  static constexpr int STAGE = RAW + XB + SB;
  // four warps a block; room for four blocks an SM up to 16 rows, two at
  // 32 (whose warps hold 128 fp32 sums a thread); the plans aim at two
  static constexpr int NWARP = 4;
  static constexpr int NT = 32 * NWARP;  // threads per block
  static constexpr int BLOCKS = NT8 == 4 ? 2 : 4;
  static constexpr int STAGES = NT8 == 2 ? 3 : 4;
  static constexpr int RING = STAGES * STAGE;  // one warp's
  static constexpr int ACC = NT8 * 4 * H * 4;  // fp32 sums a thread
  static constexpr int RED = NWARP * ACC * 32 * 4;
  static constexpr int SMEM = NWARP * RING > RED ? NWARP * RING : RED;
  static_assert(STAGE % 16 == 0, "16-byte stages");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "blocks an SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp8(uint32_t dst, const void* src,
                                    bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// byte j of w (xored with 0x80: value + 128) as a float in [-128, 127]:
// the byte becomes the low mantissa bits of 2^23, minus 2^23 + 128
__device__ __forceinline__ float s8f(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + j)) -
         8388736.f;
}

// One lane's share of a warp's copies, K tile after K tile, into the stage
// at shared address `st`: the raw weight tile (rows past K and columns past
// ld arrive as zeros, which convert to 0), the x tile (rows past M and
// columns past ldx zeros) and, grouped, the tile's group of scales (both
// halves). The lane's sources are set up once and advance a tile at a
// time: no division and no 64-bit multiply a copy.
template <int NT8, int MODE>
struct Loader {
  using S = Shape<NT8, MODE>;
  const uint8_t* wp;          // weights: row k + (lane's first row)
  const __nv_bfloat16* xp;    // x: row m0 + (lane's row), column k
  const __nv_bfloat16* sp;    // scales: this lane's chunk of the group
  long ld, wstep;  // weight row bytes; between two of the lane's rows
  int k, wrow, wdst, xdst, xc, sdst;
  int wlive, xlive[NT8], slive;
  int grp, rem, tpg, G;

  __device__ __forceinline__ Loader(const Args& a, int kt, int c0, int m0,
                                    int lane) {
    k = kt * BK;
    ld = a.ld;
    if (a.w16) {  // chunks lane + 32 j: rows lane / 4 + 8 j, 16 bytes
      wrow = lane >> 2;
      const int cc = (lane & 3) * 16;
      wdst = wrow * RS + cc;
      wlive = c0 + cc < a.ld;
      wstep = 8L * a.ld;
      wp = a.w + (long)(k + wrow) * a.ld + (wlive ? c0 + cc : 0);
    } else {  // chunks lane + 32 j: rows lane / 8 + 4 j, 8 bytes
      wrow = lane >> 3;
      const int cc = (lane & 7) * 8;
      wdst = wrow * RS + cc;
      wlive = c0 + cc < a.ld;
      wstep = 4L * a.ld;
      wp = a.w + (long)(k + wrow) * a.ld + (wlive ? c0 + cc : 0);
    }
    // x chunks lane + 32 j: rows lane / 4 + 8 j, 8 columns
    const int xr = lane >> 2;
    xc = (lane & 3) * 8;
    xdst = S::RAW + xr * XS + xc * 2;
#pragma unroll
    for (int j = 0; j < NT8; ++j) xlive[j] = m0 + xr + 8 * j < a.M;
    xp = a.x + (long)min(m0 + xr, a.M - 1) * a.ldx + k + xc;
    // scales: lanes 0-15, half lane / 8, 8 channels each
    const int sh = lane >> 3, sc = (lane & 7) * 8;
    sdst = S::RAW + S::XB + sh * (2 * TW) + sc * 2;
    slive = lane < 16 && c0 + sc < a.ld;
    G = a.G;
    if (MODE == W4_GROUPED) {  // a tile lies in one group of tpg tiles
      tpg = a.tpg;
      grp = kt / tpg;
      rem = kt - grp * tpg;
      sp = a.s + ((long)sh * a.G + grp) * a.ld + (slive ? c0 + sc : 0);
    }
  }

  // the copies of the current tile, then a step to the next
  __device__ __forceinline__ void issue(const Args& a, uint32_t st) {
    if (a.w16) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        cp16(st + wdst + j * 8 * RS, wp + j * wstep,
             wlive && k + wrow + 8 * j < a.K);
    } else {
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        cp8(st + wdst + j * 4 * RS, wp + j * wstep,
            wlive && k + wrow + 4 * j < a.K);
    }
    const long xrow = 8L * a.ldx;
    const bool xin = k + xc < a.ldx;
#pragma unroll
    for (int j = 0; j < NT8; ++j)
      cp16(st + xdst + j * 8 * XS, xp + j * xrow, xlive[j] && xin);
    if (MODE == W4_GROUPED) {
      if (slive) cp16(st + sdst, sp, true);
      if (++rem == tpg) {
        rem = 0;
        if (++grp < G) sp += a.ld;
      }
    }
    k += BK;
    wp += BK * ld;
    xp += BK;
  }
};

// W4_ODD: the scales of channel column pc, half h, at rows k and k + 1 as
// a bf16 pair
__device__ __forceinline__ uint32_t odd_scales(const Args& a, int h, int k,
                                               int pc) {
  const int gs = a.K / a.G;
  pc = min(pc, a.ld - 1);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(a.s);
  const uint32_t lo =
      __ldg(s + (long)(h * a.G + min(k / gs, a.G - 1)) * a.ld + pc);
  const uint32_t hi =
      __ldg(s + (long)(h * a.G + min((k + 1) / gs, a.G - 1)) * a.ld + pc);
  return lo | hi << 16;
}

// The products of one stage: 2 k-steps of 16 rows. Lane (g, t) owns A rows
// g and g + 8 of each m16 tile mt, which are the tile's weight columns
// 8g + mt and 8g + 4 + mt: one 8-byte load a row serves all four m16 tiles
// (without bank conflicts at the padded row stride). Its sums:
// acc[nt][mt][h][c], c = 0, 1 column 8g + mt at rows 8 nt + 2t + c, c = 2,
// 3 column 8g + 4 + mt at the same rows.
template <int NT8, int MODE>
__device__ __forceinline__ void mma_stage(
    const Args& a, const unsigned char* st, int k0, int c0, int g, int t,
    float (&acc)[NT8][4][Shape<NT8, MODE>::H][4]) {
  using S = Shape<NT8, MODE>;
  const unsigned char* xs = st + S::RAW;
  // grouped: broadcast pairs of this lane's 8 columns' scales, each half
  uint32_t sc[2][8];
  if constexpr (MODE == W4_GROUPED) {
    const unsigned char* ss = st + S::RAW + S::XB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(ss + h * (2 * TW) + 16 * g);
      const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[h][2 * j] = __byte_perm(v[j], v[j], 0x1010);
        sc[h][2 * j + 1] = __byte_perm(v[j], v[j], 0x3232);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int r0 = kk * 16 + 2 * t;
    // w[q][i]: column word 8g + 4q of rows r0, r0 + 1, r0 + 8, r0 + 9
    uint32_t w[2][4];
    {
      const unsigned char* p = st + 8 * g + r0 * RS;
      // int8: value + 128, for s8f; int4 is biased in the conversion
      const uint32_t bias = S::W4 ? 0u : 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows r0 + 0, 1, 8, 9
        const uint2 u =
            *reinterpret_cast<const uint2*>(p + ((i >> 1) * 8 + (i & 1)) * RS);
        w[0][i] = u.x ^ bias;
        w[1][i] = u.y ^ bias;
      }
    }
    uint32_t b[NT8][2];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const unsigned char* p = xs + (nt * 8 + g) * XS + r0 * 2;
      b[nt][0] = lds32(p);
      b[nt][1] = lds32(p + 16);
    }
    if constexpr (S::W4) {
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        // bytes (row k col j, row k col j', row k+1 col j, row k+1 col j')
        // for the m16 tiles j = 2 pr, j' = 2 pr + 1
        const uint32_t sel = pr ? 0x7632 : 0x5410;
        const uint32_t pw[4] = {__byte_perm(w[0][0], w[0][1], sel),
                                __byte_perm(w[1][0], w[1][1], sel),
                                __byte_perm(w[0][2], w[0][3], sel),
                                __byte_perm(w[1][2], w[1][3], sel)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mt = 2 * pr + e;
#pragma unroll
          for (int h = 0; h < S::H; ++h) {
            // (nibble & 15) ^ 8 = value + 8 in [0, 15], ored into bf16
            // 128.0 (0x4300): one and-xor with 0x4308 makes 128 + value + 8
            constexpr uint32_t MASK = 0x000F000Fu;
            constexpr uint32_t MAGIC = 0x43084308u;  // also bf16 136.0 twice
            const int sh = 8 * e + 4 * h;
            uint32_t af[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              af[i] = bf2_sub(((pw[i] >> sh) & MASK) ^ MAGIC, MAGIC);
            if constexpr (MODE == W4_GROUPED) {
              af[0] = bf2_mul(af[0], sc[h][mt]);
              af[2] = bf2_mul(af[2], sc[h][mt]);
              af[1] = bf2_mul(af[1], sc[h][4 + mt]);
              af[3] = bf2_mul(af[3], sc[h][4 + mt]);
            }
            if constexpr (MODE == W4_ODD) {
              const int pc = c0 + 8 * g + mt, k = k0 + r0;
              af[0] = bf2_mul(af[0], odd_scales(a, h, k, pc));
              af[1] = bf2_mul(af[1], odd_scales(a, h, k, pc + 4));
              af[2] = bf2_mul(af[2], odd_scales(a, h, k + 8, pc));
              af[3] = bf2_mul(af[3], odd_scales(a, h, k + 8, pc + 4));
            }
#pragma unroll
            for (int nt = 0; nt < NT8; ++nt)
              halva::mma_16816(acc[nt][mt][h], af, b[nt][0], b[nt][1]);
          }
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = i & 1, r = i & 2;  // a0..a3: (g, k), (g+8, k), ...
          af[i] = halva::pack_bf16(s8f(w[q][r], mt), s8f(w[q][r + 1], mt));
        }
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
          halva::mma_16816(acc[nt][mt][0], af, b[nt][0], b[nt][1]);
      }
    }
  }
}

// grid (weight column tiles of TW bytes, row chunks of 8 * NT8, K splits)
template <int NT8, int MODE>
__global__ void __launch_bounds__(Shape<NT8, MODE>::NT,
                                  Shape<NT8, MODE>::BLOCKS)
    dq_rows_kernel(const Args a) {
  using S = Shape<NT8, MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * TW, m0 = blockIdx.y * S::ROWS;
  const int kt = (a.K + BK - 1) / BK;
  const int t0 = blockIdx.z * a.tps;
  const int nsplit = min(kt, t0 + a.tps) - t0;
  const int share = (nsplit + S::NWARP - 1) / S::NWARP;
  const int wb = t0 + min(nsplit, warp * share);
  const int n = t0 + min(nsplit, (warp + 1) * share) - wb;
  unsigned char* ring = smem + warp * S::RING;
  const uint32_t ring_s = smem_u32(ring);

  float acc[NT8][4][S::H][4];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < S::H; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][mt][h][c] = 0.f;

  Loader<NT8, MODE> load(a, wb, c0, m0, lane);
#pragma unroll
  for (int st = 0; st < S::STAGES - 1; ++st) {
    if (st < n) load.issue(a, ring_s + st * S::STAGE);
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_wait<S::STAGES - 2>();  // this lane's copies of tile i
    __syncwarp();  // every lane's; and every lane is done with tile i - 1
    const int nxt = i + S::STAGES - 1;
    if (nxt < n) load.issue(a, ring_s + (nxt % S::STAGES) * S::STAGE);
    cp_commit();
    mma_stage<NT8, MODE>(a, ring + (i % S::STAGES) * S::STAGE,
                         (wb + i) * BK, c0, g, t, acc);
  }
  cp_wait<0>();
  __syncthreads();  // every ring is free: the warps' sums go there

  float* red = reinterpret_cast<float*>(smem);
  {
    const float* flat = &acc[0][0][0][0];
#pragma unroll
    for (int i = 0; i < S::ACC; ++i)
      red[(warp * S::ACC + i) * 32 + lane] = flat[i];
  }
  __syncthreads();

  // Quad f of the block's output: row f / (CH / 4) of the chunk, channels
  // 4 (f % (CH / 4)) .. + 3 of the tile (half h = ch / TW, weight column cc
  // = ch % TW = 8 g + 4 q + mt for mt = 0..3): sum index i of lane 4 g + t
  // in each warp's fragments, summed in warp order.
  constexpr int CH = TW * S::H;
  constexpr int QUADS = S::ROWS * CH / 4;
  constexpr int ELEMS = S::ACC * 32;
  auto place = [&](int f, int& row, int& ch) {
    const int r = f / (CH / 4), ch0 = f % (CH / 4) * 4;
    const int col = c0 + ch0 % TW;
    row = m0 + r;
    ch = (S::W4 ? ch0 / TW * a.ld : 0) + col;
    return row < a.M && col < a.ld;
  };
  auto gather = [&](int f) {
    const int r = f / (CH / 4), ch0 = f % (CH / 4) * 4;
    const int h = ch0 / TW, cc = ch0 % TW;
    const int c = 2 * ((cc >> 2) & 1) + (r & 1);
    const int lane_of = 4 * (cc >> 3) + ((r & 7) >> 1);
    float v[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int idx = ((((r >> 3) * 4 + mt) * S::H + h) * 4 + c) * 32 + lane_of;
      float sum = red[idx];
#pragma unroll
      for (int wp = 1; wp < S::NWARP; ++wp) sum += red[wp * ELEMS + idx];
      v[mt] = sum;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  };
  // y = sum times the per-channel scales (grouped scales are in the sum)
  auto store = [&](int row, int ch, float4 v) {
    if (MODE == W8 || MODE == W4_CHANNEL) {
      const uint2 u = *reinterpret_cast<const uint2*>(a.s + ch);
      v.x *= __uint_as_float(u.x << 16);
      v.y *= __uint_as_float(u.x & 0xFFFF0000u);
      v.z *= __uint_as_float(u.y << 16);
      v.w *= __uint_as_float(u.y & 0xFFFF0000u);
    }
    *reinterpret_cast<uint2*>(a.y + (long)row * a.N + ch) =
        make_uint2(halva::pack_bf16(v.x, v.y), halva::pack_bf16(v.z, v.w));
  };

  if (a.splits == 1) {
    for (int f = tid; f < QUADS; f += S::NT) {
      int row, ch;
      if (place(f, row, ch)) store(row, ch, gather(f));
    }
    return;
  }

  float* mine = a.partial + (long)blockIdx.z * a.M * a.N;
  for (int f = tid; f < QUADS; f += S::NT) {
    int row, ch;
    if (place(f, row, ch))
      *reinterpret_cast<float4*>(mine + (long)row * a.N + ch) = gather(f);
  }
  __threadfence();  // this block's partials reach L2 before its ticket
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(&a.tickets[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  // this thread's quads, split by split: their loads in flight together
  constexpr int Q = (QUADS + S::NT - 1) / S::NT;
  float4 v[Q];
  int row[Q], ch[Q];
  bool live[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int f = tid + j * S::NT;
    live[j] = f < QUADS && place(f, row[j], ch[j]);
  }
  for (int sp = 0; sp < a.splits; ++sp) {
    const float* part = a.partial + (long)sp * a.M * a.N;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (!live[j]) continue;
      const float4 u = __ldcg(
          reinterpret_cast<const float4*>(part + (long)row[j] * a.N + ch[j]));
      v[j].x += u.x;
      v[j].y += u.y;
      v[j].z += u.z;
      v[j].w += u.w;
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (live[j]) store(row[j], ch[j], v[j]);
  if (tid == 0) a.tickets[tile] = 0;
}

// One launch; above 48 KB of dynamic shared memory needs the opt-in, once
// per kernel and device (the first launch is never inside a CUDA graph
// capture: the callers warm up first). Returns a cudaError_t.
template <int NT8, int MODE>
int launch_rows(const Args& a, cudaStream_t stream) {
  using S = Shape<NT8, MODE>;
  static uint64_t smem_set = 0;
  auto kernel = dq_rows_kernel<NT8, MODE>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set |= uint64_t(1) << dev;
  }
  const dim3 grid((a.ld + TW - 1) / TW, (a.M + S::ROWS - 1) / S::ROWS,
                  a.splits);
  kernel<<<grid, S::NT, S::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// rows: the row chunk, 8, 16 or 32 (W4_ODD: 8)
template <int MODE>
int launch_rows_mode(int rows, const Args& a, cudaStream_t stream) {
  switch (rows) {
    case 8:
      return launch_rows<1, MODE>(a, stream);
    case 16:
      if constexpr (MODE != W4_ODD) return launch_rows<2, MODE>(a, stream);
      break;
    case 32:
      if constexpr (MODE != W4_ODD) return launch_rows<4, MODE>(a, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// the checks both entries make of a plan: splits * tps covers the K tiles
// with no empty split
inline bool plan_covers(int K, int splits, int tps) {
  const long kt = (K + BK - 1) / BK;
  return splits > 0 && tps > 0 && (long)splits * tps >= kt &&
         (long)(splits - 1) * tps < kt;
}

}  // namespace halva_rows
