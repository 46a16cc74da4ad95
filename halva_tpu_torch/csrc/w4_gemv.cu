// K6: decode GEMV over packed int4 weights, y (B, N) = x (B, K) @ W.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/w4_matmul.py:_w4_kernel as
// launched by w4_dense_stacked (the decode matmuls of _decode_step_w4):
//   y[b, j]        = sum_k x[b, k] * lo(w[k, j]) * s[0, k / gs, j]
//   y[b, j + N/2]  = sum_k x[b, k] * hi(w[k, j]) * s[1, k / gs, j]
// w is one layer's kernel_q4p (K, N/2) int8, split-half packed: byte [k, j]
// holds channel j in its low nibble and channel j + N/2 in its high nibble,
// two's complement in [-8, 7]. s is kernel_scale4p (2, G, N/2) bf16, gs =
// K / G (G = 1: per channel; the int4g tree's G = K / 128 is 32 or 86, any
// G that divides K works). x and y are bf16; y is written straight into
// (B, N), with no (2, B, N/2) temporary. Any B: rows go in chunks of 8, 16
// or 32 (grid y).
//
// Rounding: products and sums in fp32 on the tensor cores. G = 1 scales the
// fp32 sum at the end, as the Pallas kernel does. G > 1 rounds nibble *
// scale to bf16 before the product, as the Pallas kernel does.
//
// The loop is csrc/dq_rows.cuh, shared with the up-to-32-row path of K7
// and K8: weights as mma.sync's A operand (16 channels x 16 k) and x^T as
// its B (16 k x 8 rows), the nibbles converted by the magic number (no
// I2F), each warp's weight, x and scale tiles streamed through its own
// ring of cp.async stages, K split so that the grid fills the card in one
// wave, the splits merged by the last block's ticket. Groups that are no
// multiple of the 32-row K tile (group_size 16, say) take the W4_ODD
// variant, which reads each weight pair's scales from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_rows.cuh"

using halva_rows::Args;
using halva_rows::BK;
using halva_rows::launch_rows_mode;

// x (B, roundup(K, 8)) bf16, zeros past K; w (K, NP) int8; s (2, G, NP)
// bf16; y (B, 2*NP) bf16; partial (splits, B, 2*NP) fp32 scratch (unused
// when splits == 1); tickets: >= ceil(NP/64) * ceil(B/rc) zeroed int32. rc
// is the row chunk (8, 16 or 32; 8 where G > 1 and (K/G) % 32 != 0);
// ksplit is rows per split, a multiple of 32, and splits * ksplit covers K
// with no empty split. Returns a cudaError_t.
extern "C" int halva_w4_gemv(const void* x, const void* w, const void* s,
                             void* y, void* partial, void* tickets, int B,
                             int K, int NP, int G, int rc, int splits,
                             int ksplit, void* stream) {
  if (B <= 0 || K <= 0 || NP <= 0 || NP % 8 != 0 || G <= 0 || K % G != 0 ||
      ksplit <= 0 || ksplit % BK != 0 ||
      !halva_rows::plan_covers(K, splits, ksplit / BK))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.s = static_cast<const __nv_bfloat16*>(s);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.tickets = static_cast<int*>(tickets);
  a.M = B;
  a.K = K;
  a.ldx = (K + 7) / 8 * 8;
  a.ld = NP;
  a.N = 2 * NP;
  a.G = G;
  a.splits = splits;
  a.tps = ksplit / BK;
  a.w16 = NP % 16 == 0;
  a.tpg = (K / G) / BK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 1)
    return launch_rows_mode<halva_rows::W4_CHANNEL>(rc, a, st);
  if ((K / G) % BK == 0)
    return launch_rows_mode<halva_rows::W4_GROUPED>(rc, a, st);
  return launch_rows_mode<halva_rows::W4_ODD>(rc, a, st);
}
