// A probe, not a kernel of the port: the M-tiled dequantizing GEMM loop of
// halva_tpu_torch/csrc/dq_gemm.cu as it stood before its 128-row tile was
// redesigned (cp.async stages, a conversion pass into shared memory between
// two barriers, ldmatrix + mma.sync), with clock64 stamps at the phase
// boundaries of each K tile: wait (cp.async.wait_group + barrier), issue
// (the next tile's cp.async), convert, barrier, mma. Lane 0 of the first and
// of the last warp of every block writes its cycles per phase, the loop's
// cycles and globaltimer ns, and its K-tile count to `stamps` (16 int64 per
// block). Built and run by scripts/dq_gemm_phases.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../halva_tpu_torch/csrc/mma_bf16.cuh"

namespace {

using halva::ldmatrix_x4;
using halva::ldmatrix_x4_trans;
using halva::mma_16816;
using halva::pack_bf16;

constexpr int NT = 256;       // threads per block, 8 warps
constexpr int BK = 64;        // K rows per tile
constexpr int ASTR = BK + 8;  // bf16 per x row in shared memory (padded)


__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

enum Mode { W8 = 0, W4_CHANNEL = 1, W4_GROUPED = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// byte i of w (already xored with 0x80) as a float in [-128, 127]: the byte
// becomes the low mantissa bits of 2^23, minus 2^23 + 128
__device__ __forceinline__ float s8_to_float(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

template <int BM, int BN, int MODE, int STAGES>
constexpr int smem_bytes() {
  return STAGES * (BM * ASTR * 2 + BK * (MODE == W8 ? BN : BN / 2)) +
         BK * (BN + 8) * 2;
}

// grid (column tiles, row tiles, K splits). A block owns BM rows and BN
// output channels. LD is the weights' row length in bytes: N/2 for K7, N for
// K8. tps: K tiles per split.
template <int BM, int BN, int WM, int WN, int MODE, int STAGES, int MINB>
__global__ void __launch_bounds__(NT, MINB)
probe_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ w,
               const __nv_bfloat16* __restrict__ s,
               __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
               int* __restrict__ tickets, int M, int K, int N, int G,
               int splits, int tps, long long* __restrict__ stamps) {
  constexpr bool W4 = MODE != W8;
  constexpr int RAWB = W4 ? BN / 2 : BN;  // raw bytes per K row of the tile
  constexpr int BSTR = BN + 8;  // bf16 per converted weight row (padded)
  constexpr int WPR = RAWB / 4;  // 32-bit words per raw row
  constexpr int RPP = NT / WPR;  // rows one pass of the block converts
  static_assert(NT % WPR == 0 && BK % RPP == 0, "convert passes");
  constexpr int A_ELEMS = BM * ASTR;
  constexpr int RAW_BYTES = BK * RAWB;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MT = WTM / 16, NT8 = WTN / 8;
  static_assert(WM * WN * 32 == NT, "8 warps");
  static_assert(MT >= 1 && NT8 >= 2 && NT8 % 2 == 0, "warp tile");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* Ws = smem + STAGES * A_ELEMS * 2;
  __nv_bfloat16* Bs =
      reinterpret_cast<__nv_bfloat16*>(Ws + STAGES * RAW_BYTES);
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WN) * WTM, wn0 = (warp % WN) * WTN;
  const int m0 = blockIdx.y * BM;
  const int LD = W4 ? N / 2 : N;
  const int c0 = blockIdx.x * RAWB;  // first packed column (K7) or channel
  const int split = blockIdx.z;
  const int kt0 = split * tps;
  const int nkt = min(K / BK, kt0 + tps) - kt0;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * A_ELEMS;
    for (int c = tid; c < BM * (BK / 8); c += NT) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      const int row = m0 + r;
      cp_async16(as + r * ASTR + cc * 8,
                 x + (long)min(row, M - 1) * K + k0 + cc * 8,
                 row < M ? 16 : 0);
    }
    uint8_t* ws = Ws + stage * RAW_BYTES;
    for (int c = tid; c < BK * (RAWB / 8); c += NT) {
      const int r = c / (RAWB / 8), cc = c % (RAWB / 8);
      const int col = c0 + cc * 8;
      const bool in = col < LD;  // LD % 8 == 0: a chunk is all in or out
      cp_async8(ws + r * RAWB + cc * 8,
                w + (long)(k0 + r) * LD + (in ? col : 0), in ? 8 : 0);
    }
  };

  // K7, G > 1: this thread's 4 + 4 scales of the current group, paired as
  // the converted values are: (col 0, col 2) and (col 1, col 3)
  uint32_t sl02 = 0, sl13 = 0, sh02 = 0, sh13 = 0;
  int cur_group = -1;
  const int gs = K / G;

  auto convert_tile = [&](int stage, int kt) {
    const uint32_t* wr =
        reinterpret_cast<const uint32_t*>(Ws + stage * RAW_BYTES);
    // this thread converts word wc of rows tid / WPR + RPP j
    const int wc = tid % WPR;
    if (W4) {
      if (MODE == W4_GROUPED) {
        const int group = kt * BK / gs;
        if (group != cur_group) {
          cur_group = group;
          const int pc = c0 + 4 * wc;
          uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
          if (pc < LD) {
            lo = *reinterpret_cast<const uint2*>(s + (long)group * LD + pc);
            hi = *reinterpret_cast<const uint2*>(s + (long)(G + group) * LD +
                                                 pc);
          }
          sl02 = __byte_perm(lo.x, lo.y, 0x5410);
          sl13 = __byte_perm(lo.x, lo.y, 0x7632);
          sh02 = __byte_perm(hi.x, hi.y, 0x5410);
          sh13 = __byte_perm(hi.x, hi.y, 0x7632);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / RPP; ++j) {
        const int r = tid / WPR + RPP * j;
        // nibble ^ 8 = value + 8 in [0, 15]; 0x4300 | that = bf16 128 + it
        const uint32_t v = wr[r * WPR + wc] ^ 0x88888888u;
        constexpr uint32_t MASK = 0x000F000Fu, ONE28 = 0x43004300u;
        constexpr uint32_t BIAS = 0x43084308u;  // bf16 136.0 twice
        uint32_t lo02 = bf2_sub((v & MASK) | ONE28, BIAS);
        uint32_t hi02 = bf2_sub(((v >> 4) & MASK) | ONE28, BIAS);
        uint32_t lo13 = bf2_sub(((v >> 8) & MASK) | ONE28, BIAS);
        uint32_t hi13 = bf2_sub(((v >> 12) & MASK) | ONE28, BIAS);
        if (MODE == W4_GROUPED) {
          lo02 = bf2_mul(lo02, sl02);
          lo13 = bf2_mul(lo13, sl13);
          hi02 = bf2_mul(hi02, sh02);
          hi13 = bf2_mul(hi13, sh13);
        }
        __nv_bfloat16* row = Bs + r * BSTR + 4 * wc;
        *reinterpret_cast<uint2*>(row) =
            make_uint2(__byte_perm(lo02, lo13, 0x5410),
                       __byte_perm(lo02, lo13, 0x7632));
        *reinterpret_cast<uint2*>(row + BN / 2) =
            make_uint2(__byte_perm(hi02, hi13, 0x5410),
                       __byte_perm(hi02, hi13, 0x7632));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / RPP; ++j) {
        const int r = tid / WPR + RPP * j;
        const uint32_t v = wr[r * WPR + wc] ^ 0x80808080u;
        *reinterpret_cast<uint2*>(Bs + r * BSTR + 4 * wc) = make_uint2(
            pack_bf16(s8_to_float(v, 0x7440), s8_to_float(v, 0x7441)),
            pack_bf16(s8_to_float(v, 0x7442), s8_to_float(v, 0x7443)));
      }
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nkt) load_tile(st, kt0 + st);
    cp_async_commit();
  }
  const int lrow = (lane & 7) + (lane & 8);
  const int lcol = (lane & 16) >> 1;
  long long ph[5] = {0, 0, 0, 0, 0};
  const long long g_start = gtimer();
  long long t_prev = clk();
  const long long c_start = t_prev;
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();              // everyone's; and tile i-1 is consumed
    long long tc = clk(); ph[0] += tc - t_prev; t_prev = tc;
    const int nxt = i + STAGES - 1;
    if (nxt < nkt) load_tile(nxt % STAGES, kt0 + nxt);
    cp_async_commit();
    tc = clk(); ph[1] += tc - t_prev; t_prev = tc;
    const int stage = i % STAGES;
    convert_tile(stage, kt0 + i);
    tc = clk(); ph[2] += tc - t_prev; t_prev = tc;
    __syncthreads();
    tc = clk(); ph[3] += tc - t_prev; t_prev = tc;
    const __nv_bfloat16* as = As + stage * A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], as + (wm0 + mt * 16 + lrow) * ASTR + kk * 16 +
                               lcol);
      const __nv_bfloat16* br = Bs + (kk * 16 + lrow) * BSTR + wn0 + lcol;
#pragma unroll
      for (int nt = 0; nt < NT8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, br + nt * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][nt], a[mt], b[0], b[1]);
          mma_16816(acc[mt][nt + 1], a[mt], b[2], b[3]);
        }
      }
    }
    tc = clk(); ph[4] += tc - t_prev; t_prev = tc;
  }
  cp_async_wait<0>();
  if (lane == 0 && (warp == 0 || warp == NT / 32 - 1)) {
    const long bl = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
    long long* out = stamps + bl * 16 + (warp == 0 ? 0 : 8);
    for (int p = 0; p < 5; ++p) out[p] = ph[p];
    out[5] = t_prev - c_start;
    out[6] = gtimer() - g_start;
    out[7] = nkt;
  }

  // column c (even) of the block tile -> output channel n; false past the
  // edge. K7: the first BN/2 columns are the low-nibble channels, the rest
  // the high-nibble ones
  auto channel = [&](int c, int& n) {
    if (W4) {
      const int pc = c0 + (c & (BN / 2 - 1));
      n = (c >= BN / 2 ? LD : 0) + pc;
      return pc < LD;
    }
    n = c0 + c;
    return n < N;
  };
  // the per-channel scale multiplies the fp32 sum; a grouped K7 has scaled
  // its weights already. (2, 1, N/2) flat is indexed by the channel too.
  auto scale_of = [&](int n) {
    return MODE == W4_GROUPED ? 1.f : __bfloat162float(s[n]);
  };

  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      int n;
      if (!channel(wn0 + nt * 8 + 2 * t, n)) continue;
      const float s0 = scale_of(n), s1 = scale_of(n + 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + wm0 + mt * 16 + g, r1 = r0 + 8;
        if (r0 < M)
          *reinterpret_cast<uint32_t*>(y + (long)r0 * N + n) =
              pack_bf16(acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
        if (r1 < M)
          *reinterpret_cast<uint32_t*>(y + (long)r1 * N + n) =
              pack_bf16(acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
      }
    }
    return;
  }

  float* mine = partial + (long)split * M * N;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    int n;
    if (!channel(wn0 + nt * 8 + 2 * t, n)) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = m0 + wm0 + mt * 16 + g, r1 = r0 + 8;
      if (r0 < M)
        *reinterpret_cast<float2*>(mine + (long)r0 * N + n) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r1 < M)
        *reinterpret_cast<float2*>(mine + (long)r1 * N + n) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __threadfence();  // this block's partials reach L2 before its ticket
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(&tickets[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    int n;
    if (!channel(wn0 + nt * 8 + 2 * t, n)) continue;
    const float s0 = scale_of(n), s1 = scale_of(n + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm0 + mt * 16 + g + 8 * h;
        if (r >= M) continue;
        const long off = (long)r * N + n;
        float2 v = make_float2(0.f, 0.f);
        for (int sp = 0; sp < splits; ++sp) {
          const float2 p = __ldcg(
              reinterpret_cast<const float2*>(partial + (long)sp * M * N +
                                              off));
          v.x += p.x;
          v.y += p.y;
        }
        *reinterpret_cast<uint32_t*>(y + off) =
            pack_bf16(v.x * s0, v.y * s1);
      }
    }
  }
  if (tid == 0) tickets[tile] = 0;
}

}  // namespace

extern "C" int probe_dq_gemm(int mode, const void* x, const void* w,
                             const void* s, void* y, void* partial,
                             void* tickets, int M, int K, int N, int G,
                             int splits, int tps, void* stamps) {
  constexpr int BM = 128, BN = 128, STAGES = 3;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  auto* tp = static_cast<int*>(tickets);
  auto* st = static_cast<long long*>(stamps);
  cudaError_t err;
#define PROBE_LAUNCH(MODE)                                                  \
  {                                                                         \
    auto kernel = probe_kernel<BM, BN, 2, 4, MODE, STAGES, 2>;              \
    constexpr int bytes = smem_bytes<BM, BN, MODE, STAGES>();               \
    err = cudaFuncSetAttribute(                                             \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);        \
    if (err != cudaSuccess) return (int)err;                                \
    kernel<<<grid, NT, bytes>>>(xp, wp, sp, yp, pp, tp, M, K, N, G, splits, \
                                tps, st);                                   \
  }
  if (mode == 0) PROBE_LAUNCH(W8)
  else if (G == 1) PROBE_LAUNCH(W4_CHANNEL)
  else PROBE_LAUNCH(W4_GROUPED)
  return (int)cudaGetLastError();
}
