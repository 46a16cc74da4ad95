// Device code shared by the decode-attention kernels (decode_attn.cu, K4;
// fold_attn.cu, K5): the cache formats, nibble and byte conversions, and the
// cp.async copies of their staged tile loops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace halva_decode {

constexpr int NT = 256;   // threads per block of K4
constexpr float M_INIT = -1e29f;  // running max before any visible key
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint16_t BF16_ONE = 0x3F80;

enum Fmt { BF16 = 0, I8 = 1, I4 = 2 };

// signed nibble (low if sh == 0, high if sh == 4) of byte j of w
__device__ __forceinline__ float nib(uint32_t w, int j, int sh) {
  return (float)((int32_t)(w << (28 - 8 * j - sh)) >> 28);
}

__device__ __forceinline__ float sbyte(uint32_t w, int j) {
  return (float)((int32_t)(w << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ float bf16_bits(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// 16 bytes global -> shared; zero-filled and nothing read when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// all but the N most recent groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int F>
__host__ __device__ constexpr int row_bytes(int D) {
  return F == BF16 ? 2 * D : D;
}

}  // namespace halva_decode
