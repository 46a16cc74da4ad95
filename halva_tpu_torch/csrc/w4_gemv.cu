// K6: decode GEMV over packed int4 weights, y (B, N) = x (B, K) @ W.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/w4_matmul.py:_w4_kernel as
// launched by w4_dense_stacked (the decode matmuls of _decode_step_w4):
//   y[b, j]        = sum_k x[b, k] * lo(w[k, j]) * s[0, k / gs, j]
//   y[b, j + N/2]  = sum_k x[b, k] * hi(w[k, j]) * s[1, k / gs, j]
// w is one layer's kernel_q4p (K, N/2) int8, split-half packed: byte [k, j]
// holds channel j in its low nibble and channel j + N/2 in its high nibble,
// each sign-extended to [-8, 7] by an arithmetic shift of a 32-bit value.
// s is kernel_scale4p (2, G, N/2) bf16, gs = K / G (G = 1: per channel; the
// int4g tree's G = K / 128 is 32 or 86, any G that divides K works). x and y
// are bf16; y is written straight into (B, N), with no (2, B, N/2) temporary.
//
// Rounding: products and sums in fp32. G = 1 scales the fp32 dot by s at the
// end, as the Pallas kernel does. G > 1 multiplies each nibble by its scale
// in fp32 (exact: 4-bit times 8-bit mantissas) before the dot; the Pallas
// kernel rounds that product to bf16 first, a difference of at most 2^-9
// relative per weight, far inside the stated tolerance.
//
// What bounds it on an H100: at decode batch sizes, the weight bytes
// (K * N/2 per call, 22.5 MB for the 7B gate/up); x is a few KB and stays in
// L1/L2. The design reads every packed byte once for all rows of a chunk of
// up to 8 batch rows:
//   - a block of 256 threads owns 64 packed columns (128 output channels) and
//     a split of K; 8 column lanes x 8 bytes make 64-byte row segments, and
//     each of the 32 k lanes takes a contiguous run of the split's rows (so
//     its rows rarely leave one scale group), loading 8 rows ahead before it
//     converts any: a first version that loaded one row at a time and
//     strode over the rows took 0.0945 ms for gate at B=4 on an H100;
//   - each thread keeps fp32 sums for 16 channels x RC rows in registers;
//     the 32 k lanes are reduced with warp shuffles and shared memory;
//   - K is split across blocks until the grid holds ~2 blocks per SM (the
//     plan is made by w4_matmul.plan); the last block of a tile to finish
//     (a ticket taken with atomicAdd after a __threadfence) sums the fp32
//     partials of all splits in split order and writes y, so the result is
//     deterministic and one launch does everything. It resets its ticket, so
//     the ticket buffer is zeroed once and reused by later launches.
// Large B runs as several row chunks (grid y), each re-reading the weights
// from L2. Not done yet: tensor-core products (mma/wgmma) for large B, and an
// int4 -> float conversion cheaper than I2F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int CL = 8;          // column lanes, 8 packed bytes each
constexpr int TN = CL * 8;     // packed columns per block
constexpr int KL = NT / CL;    // k lanes
constexpr int NW = NT / 32;    // warps
constexpr int PF = 8;          // rows of packed bytes a thread keeps in flight

__device__ __forceinline__ float lo_nib(uint32_t w, int j) {
  return (float)((int32_t)(w << (28 - 8 * j)) >> 28);
}

__device__ __forceinline__ float hi_nib(uint32_t w, int j) {
  return (float)((int32_t)(w << (24 - 8 * j)) >> 28);
}

// 8 consecutive bf16 scales (16 bytes) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int RC, bool GROUPED>
__global__ void __launch_bounds__(NT)
w4_gemv_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ w,
               const __nv_bfloat16* __restrict__ s,
               __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
               int* __restrict__ tickets, int B, int K, int NP, int G,
               int splits, int ksplit) {
  __shared__ float red[NW][CL][RC * 16];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int cl = tid % CL, kl = tid / CL;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * TN + cl * 8;
  const int row0 = blockIdx.y * RC;
  const int split = blockIdx.z;
  const int kbeg = split * ksplit;
  const int kend = min(K, kbeg + ksplit);
  const int gs = K / G;

  float acc[RC][16];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[r][i] = 0.f;

  // rows past B (a partial chunk) read row B-1 and are never written
  const __nv_bfloat16* xr[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) xr[r] = x + (long)min(row0 + r, B - 1) * K;

  if (col0 < NP) {  // NP % 8 == 0: a thread's 8 columns are all in or out
    float sc[16];
    int g_end = -1;
    // this k lane's contiguous run of the split's rows: a run of up to
    // ksplit / 32 rows rarely crosses a scale group
    const int span = (kend - kbeg + KL - 1) / KL;
    const int kb = kbeg + kl * span, ke = min(kend, kb + span);
    for (int k0 = kb; k0 < ke; k0 += PF) {
      // PF rows of packed bytes in flight before any is used
      uint2 wbuf[PF];
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int k = k0 + u;
        wbuf[u] = k < ke ? __ldg(reinterpret_cast<const uint2*>(
                               w + (long)k * NP + col0))
                         : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int k = k0 + u;
        if (k >= ke) break;
        if (GROUPED && k >= g_end) {
          const int g = k / gs;
          g_end = (g + 1) * gs;
          load8(s + (long)g * NP + col0, sc);
          load8(s + (long)(G + g) * NP + col0, sc + 8);
        }
        const uint2 wv = wbuf[u];
        float wf[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wf[j] = lo_nib(wv.x, j);
          wf[4 + j] = lo_nib(wv.y, j);
          wf[8 + j] = hi_nib(wv.x, j);
          wf[12 + j] = hi_nib(wv.y, j);
        }
        if (GROUPED) {
#pragma unroll
          for (int i = 0; i < 16; ++i) wf[i] *= sc[i];
        }
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const float xv = __bfloat162float(xr[r][k]);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[r][i] = fmaf(xv, wf[i], acc[r][i]);
        }
      }
    }
  }

  // the 4 k lanes of a warp that share a column lane, then the 8 warps
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float v = acc[r][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][i] = v;
    }
  if (lane < CL) {
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i) red[warp][lane][r * 16 + i] = acc[r][i];
  }
  __syncthreads();

  const long n2 = 2L * NP;
  // output o of the block: column lane c, row r, channel i of the lane
  auto out_index = [&](int o, int& row, int& pc, int& half) {
    const int c = o / (RC * 16), ri = o % (RC * 16);
    const int r = ri / 16, i = ri % 16;
    row = row0 + r;
    pc = blockIdx.x * TN + c * 8 + (i % 8);
    half = i / 8;
    return ri;
  };
  auto finish = [&](float v, int pc, int half) {
    // G = 1: the per-channel scale multiplies the fp32 dot
    return GROUPED ? v : v * __bfloat162float(s[(long)half * NP + pc]);
  };

  if (splits == 1) {
    for (int o = tid; o < CL * RC * 16; o += NT) {
      int row, pc, half;
      const int ri = out_index(o, row, pc, half);
      if (row >= B || pc >= NP) continue;
      float v = 0.f;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) v += red[wp][o / (RC * 16)][ri];
      y[row * n2 + (long)half * NP + pc] = __float2bfloat16(finish(v, pc, half));
    }
    return;
  }

  for (int o = tid; o < CL * RC * 16; o += NT) {
    int row, pc, half;
    const int ri = out_index(o, row, pc, half);
    if (row >= B || pc >= NP) continue;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < NW; ++wp) v += red[wp][o / (RC * 16)][ri];
    partial[((long)split * B + row) * n2 + (long)half * NP + pc] = v;
  }
  __threadfence();  // this block's partials reach L2 before its ticket
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(&tickets[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  for (int o = tid; o < CL * RC * 16; o += NT) {
    int row, pc, half;
    out_index(o, row, pc, half);
    if (row >= B || pc >= NP) continue;
    const long off = (long)row * n2 + (long)half * NP + pc;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      v += __ldcg(partial + (long)sp * B * n2 + off);
    y[off] = __float2bfloat16(finish(v, pc, half));
  }
  if (tid == 0) tickets[tile] = 0;
}

template <int RC>
int launch_rc(bool grouped, dim3 grid, cudaStream_t st,
              const __nv_bfloat16* x, const uint8_t* w,
              const __nv_bfloat16* s, __nv_bfloat16* y, float* partial,
              int* tickets, int B, int K, int NP, int G, int splits,
              int ksplit) {
  if (grouped)
    w4_gemv_kernel<RC, true><<<grid, NT, 0, st>>>(
        x, w, s, y, partial, tickets, B, K, NP, G, splits, ksplit);
  else
    w4_gemv_kernel<RC, false><<<grid, NT, 0, st>>>(
        x, w, s, y, partial, tickets, B, K, NP, G, splits, ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, K) bf16; w (K, NP) int8; s (2, G, NP) bf16; y (B, 2*NP) bf16;
// partial (splits, B, 2*NP) fp32 scratch (unused when splits == 1);
// tickets: >= ceil(NP/64) * ceil(B/rc) zeroed int32. rc is the row chunk
// (1, 2, 4 or 8); splits * ksplit covers K. Returns a cudaError_t.
extern "C" int halva_w4_gemv(const void* x, const void* w, const void* s,
                             void* y, void* partial, void* tickets, int B,
                             int K, int NP, int G, int rc, int splits,
                             int ksplit, void* stream) {
  if (B <= 0 || K <= 0 || NP <= 0 || NP % 8 != 0 || G <= 0 || K % G != 0 ||
      splits <= 0 || ksplit <= 0 || (long)splits * ksplit < K ||
      (long)(splits - 1) * ksplit >= K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((NP + TN - 1) / TN, (B + rc - 1) / rc, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  auto* tp = static_cast<int*>(tickets);
  const bool grouped = G > 1;
  switch (rc) {
    case 1:
      return launch_rc<1>(grouped, grid, st, xp, wp, sp, yp, pp, tp, B, K, NP,
                          G, splits, ksplit);
    case 2:
      return launch_rc<2>(grouped, grid, st, xp, wp, sp, yp, pp, tp, B, K, NP,
                          G, splits, ksplit);
    case 4:
      return launch_rc<4>(grouped, grid, st, xp, wp, sp, yp, pp, tp, B, K, NP,
                          G, splits, ksplit);
    case 8:
      return launch_rc<8>(grouped, grid, st, xp, wp, sp, yp, pp, tp, B, K, NP,
                          G, splits, ksplit);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
