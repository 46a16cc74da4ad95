// Pieces shared by the flash-attention kernels on Hopper (flash_fwd.cu: K1,
// flash_bwd.cu: K2 and K3): the head dim and its swizzle halves, the tile
// rule (skip / masked / full), the exp2 and bf16 packing on the accumulator
// layout, a warp's id-range reduction, the (B, S, heads, D) tensor map, and
// the launcher's check of the setmaxnreg register pool.

#pragma once

#include <cuda.h>  // CUtensorMap (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace halva {
namespace flash {

constexpr int D = 128;         // head dim
constexpr int HALF_COLS = 64;  // head-dim columns of one 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;
constexpr int IMAX = 0x7fffffff, IMIN = -IMAX - 1;  // empty id ranges

enum TileKind { SKIP = 0, MASKED = 1, FULL = 2 };

// The kind of key tile [c0, c0 + BK) for query rows at positions [p_lo,
// p_hi] whose segment ids span [qmin, qmax] (qmin == qmax == 0: no live
// row), the tile's ids (of keys below Skv) spanning [kmin, kmax]. As
// ops/flash_attention.py:flash_tile_kind.
template <int BK>
__device__ __forceinline__ int tile_kind(int c0, int kmin, int kmax, int qmin,
                                         int qmax, int p_lo, int p_hi,
                                         int Skv, int causal, int window) {
  const int c_last = min(c0 + BK, Skv) - 1;
  if ((qmin == 0 && qmax == 0) || (kmin == 0 && kmax == 0) || kmax < qmin ||
      kmin > qmax)
    return SKIP;
  if (causal && c0 > p_hi) return SKIP;
  if (window > 0 && p_lo - c_last >= window) return SKIP;
  const bool full = c0 + BK <= Skv && qmin == qmax && kmin == kmax &&
                    qmin == kmin && (!causal || p_lo >= c_last) &&
                    (window == 0 || p_hi - c0 < window);
  return full ? FULL : MASKED;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void warp_range(int& mn, int& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

// A (B, S, heads, D) bf16 tensor as (D, heads, S, B), loaded in boxes of 64
// head-dim columns (128 bytes, swizzled for wgmma) x `rows` positions of one
// head; positions past S arrive as zeros
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S,
                       int heads, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {HALF_COLS, 1, (cuuint32_t)rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 4, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The registers the consumer warpgroups ask for with setmaxnreg come from
// the pool the block holds at launch: `threads` x the entry register count
// (168 for 384 threads under __launch_bounds__(384, 1)). A kernel whose
// entry count leaves too few would wait forever: 0 if it leaves enough,
// else an error to refuse the launch with.
template <typename Kernel>
int setmaxnreg_pool_ok(Kernel kernel, int threads, int consumer_threads,
                       int consumer_regs, int producer_regs) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  return attr.numRegs * threads >=
                 consumer_threads * consumer_regs +
                     (threads - consumer_threads) * producer_regs
             ? 0
             : (int)cudaErrorInvalidConfiguration;
}

}  // namespace flash
}  // namespace halva
