// K1: FlashAttention-2 forward with segment ids, causal masking and GQA,
// bf16 in and out, fp32 accumulation and softmax statistics.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_fwd_impl). Same contract: a query attends a key
// iff both carry the same nonzero segment id and, when causal, the key's
// index is not past the query's; query head h reads kv head h / (H / KVH);
// the log-sum-exp (natural log) of every row is written for the backward.
//
// What bounds it on an H100: at the llava-1.5-7b prefill shape (B=4, H=32,
// S=623, D=128) the live causal QK^T and PV are ~12.5 GFLOP against ~82 MB
// of q, k, v and o, ~150 FLOP per byte: below the H100's ~295 FLOP/byte
// ridge, so read-once traffic would bound it at ~25 us. This first version
// is far from that: it is bound by latency, with synchronous tile loads.
// The design keeps every product on the tensor cores (mma.sync m16n8k16
// bf16 -> fp32) and all softmax state in registers:
//   - one block of 4 warps per (64-query tile, head, batch row); each warp
//     owns 16 query rows, whose Q fragments stay in registers for the whole
//     key loop;
//   - K and V tiles of 64 keys are staged row-major in shared memory with a
//     padded row stride (conflict-free fragment reads); the PV operand is
//     read transposed with ldmatrix.trans;
//   - the S accumulator layout of one mma is the A-operand layout of the
//     next, so P never leaves registers (the FlashAttention-2 trick);
//   - key tiles wholly above the diagonal are never visited.
// Not done yet (later work): wgmma, TMA, cp.async double buffering, split
// along the key axis. The reference's ALiBi, sliding window and q_offset
// modes are not ported; the Python wrapper refuses them.
//
// Inputs are in the framework's (B, S, H, D) layout; the kernel addresses
// rows by stride, so no transposed copy is made. Rows of a fully masked
// query (segment id 0) come out as 0 with LSE = M_INIT * ln 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // query rows per block (16 per warp)
constexpr int BK = 64;      // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;  // logit of a masked pair (selected, not added)
constexpr float M_INIT = -1e29f;   // running-max start above NEG_BIG: masked p = 0
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ qseg, const int* __restrict__ kvseg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, int KVH, float scale_log2,
                 int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int STR = D + 8;  // padded smem row stride (bf16): 16B-aligned rows
  constexpr int CH = D / 8;   // 16-byte chunks per row
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

  const long q_row = (long)H * D;     // elements between sequence positions
  const long kv_row = (long)KVH * D;
  const __nv_bfloat16* qb = q + (long)b * Sq * q_row + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Skv * kv_row + (long)kvh * D;
  const __nv_bfloat16* vb = v + (long)b * Skv * kv_row + (long)kvh * D;

  // Q as the A operand: a0 (row g, k 2t..2t+1), a1 (row g+8), a2/a3 (k+8)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = r0 < Sq ? ld32(qb + r0 * q_row + c) : 0u;
    qf[kk][1] = r1 < Sq ? ld32(qb + r1 * q_row + c) : 0u;
    qf[kk][2] = r0 < Sq ? ld32(qb + r0 * q_row + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ld32(qb + r1 * q_row + c + 8) : 0u;
  }
  const int qs0 = r0 < Sq ? qseg[(long)b * Sq + r0] : 0;
  const int qs1 = r1 < Sq ? qseg[(long)b * Sq + r1] : 0;

  float oacc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = M_INIT, m1 = M_INIT, l0 = 0.f, l1 = 0.f;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // the previous tile's shared reads are done
    for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (c0 + r < Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (c0 + r) * kv_row + c);
        vx = *reinterpret_cast<const uint4*>(vb + (c0 + r) * kv_row + c);
      }
      *reinterpret_cast<uint4*>(ks + r * STR + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * STR + c) = vx;
    }
    if (threadIdx.x < BK)
      kvsegs[threadIdx.x] =
          c0 + threadIdx.x < Skv ? kvseg[(long)b * Skv + c0 + threadIdx.x] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys; B operand b0 = K[key g][k 2t..]
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * STR + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // mask, scale into the exp2 domain, row max over the quad of lanes
    float mx0 = M_INIT, mx1 = M_INIT;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = nt * 8 + tig * 2 + e;
        const int col = c0 + cl;
        const int cs = kvsegs[cl];
        const bool in = col < Skv;
        const bool ok0 = in && qs0 != 0 && cs == qs0 && (!causal || r0 >= col);
        const bool ok1 = in && qs1 != 0 && cs == qs1 && (!causal || r1 >= col);
        s[nt][e] = ok0 ? s[nt][e] * scale_log2 : NEG_BIG;
        s[nt][2 + e] = ok1 ? s[nt][2 + e] * scale_log2 : NEG_BIG;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= al0;
      oacc[dt][1] *= al0;
      oacc[dt][2] *= al1;
      oacc[dt][3] *= al1;
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A operand
    // of k-step kk. B (keys x dims) comes from row-major V via ldmatrix.trans:
    // lane L addresses key row kk*16 + (L&8) + (L&7) of dim block dt*8 + (L&16)/2
    const int lrow = (lane & 7) + (lane & 8);
    const int lcol = (lane & 16) >> 1;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = vs + (kk * 16 + lrow) * STR + lcol;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vr + dt * 8);
        mma_16816(oacc[dt], pa, bv[0], bv[1]);
        mma_16816(oacc[dt + 1], pa, bv[2], bv[3]);
      }
    }
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + (long)b * Sq * q_row + (long)h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
  if (tig == 0) {
    float* lb = lse + ((long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = m0 * LN2 + logf(l0 > 0.f ? l0 : 1.f);
    if (r1 < Sq) lb[r1] = m1 * LN2 + logf(l1 > 0.f ? l1 : 1.f);
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, KVH, D) bf16; qseg (B, Sq), kvseg (B, Skv)
// int32; o (B, Sq, H, D) bf16; lse (B, H, Sq) fp32. Returns a cudaError_t.
extern "C" int halva_flash_fwd_bf16(const void* q, const void* k,
                                    const void* v, const void* qseg,
                                    const void* kvseg, void* o, void* lse,
                                    int B, int Sq, int Skv, int H, int KVH,
                                    int D, float scale, int causal,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* qs = static_cast<const int*>(qseg);
  const auto* kvs = static_cast<const int*>(kvseg);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D != 128)  // the head dim of every supported Llama config
    return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<128><<<grid, NTHREADS, 0, st>>>(
      qp, kp, vp, qs, kvs, op, lp, Sq, Skv, H, KVH, sl2, causal);
  return (int)cudaGetLastError();
}

extern "C" const char* halva_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
