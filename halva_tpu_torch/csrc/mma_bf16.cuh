// Tensor-core helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) and the quantized-weight GEMMs (dq_gemm.cu): mma.sync
// m16n8k16 bf16 -> fp32 and its operand loads.
//
// Fragment layouts (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (row g, cols 2t..2t+1), a1 = (row g+8, same),
//                         a2 = (row g, cols 2t+8..2t+9), a3 = (row g+8, same)
//   B (16x8, "col"):      b0 = (rows 2t..2t+1, col g),
//                         b1 = (rows 2t+8..2t+9, col g)
//   C (16x8, fp32):       c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row g+8
// So the C fragments of two neighbouring n-tiles, packed to bf16 pairs, are
// the A fragment of the next product (the FlashAttention-2 register trick).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace halva {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way in.
// For B operands (k rows x n cols) stored row-major as [k][n]: lane L gives
// the address of row (L & 7) + (L & 8), column block (L & 16) / 2 of a 16x16
// tile; r0, r1 are then b0, b1 of the tile's first 8 columns, r2, r3 of the
// next 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8x8 bf16 matrices from shared memory as they lie. For A operands
// (m rows x k cols) stored row-major as [m][k]: lane L gives the address of
// row (L & 7) + (L & 8), column block (L & 16) / 2 of a 16x16 tile; r0..r3
// are then a0..a3 of mma_16816.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4],
                                            const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace halva
