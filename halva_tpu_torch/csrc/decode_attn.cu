// K4: one-query decode attention over a layer's prompt KV cache merged with
// its generated-token cache in one softmax, bf16 caches, GQA grouped.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/decode_attention.py:
// _decode_kernel (pallas_call in decode_attend_layer), bf16 mode. Same
// contract: prompt key j is visible iff prompt_seg[b, j] != 0, gen slot j iff
// gen_valid[b, j]; the G = H / KVH query heads of kv head n are heads
// n*G .. n*G+G-1; a row with no visible key comes out as 0.
//
// What bounds it on an H100: memory bandwidth. Per call it reads the layer's
// caches once, B*KVH*(Sp+Sg)*D*2*2 bytes (49 MB at llava-1.5-7b B=4, Sp=623,
// Sg=128), at ~G FLOP per byte (G query heads per kv head): far below the
// ridge, so bytes are the whole cost. The design streams each cache row
// exactly once and skips rows that are masked:
//   - one block of 256 threads per (kv head, batch row) carries all G query
//     heads of that kv head, so a key or value row is read once for G heads
//     (the reference's grouped GQA, with no repeated cache);
//   - keys arrive in tiles of 128 rows; 16-byte loads, D/8 lanes per row,
//     the dot products reduced with warp shuffles into shared logits;
//   - one warp per head runs the online softmax (exp2 domain, fp32) over a
//     tile; the PV pass has each thread own two adjacent dims of a slice of
//     the tile's rows, so a warp's value loads are contiguous;
//   - the prompt tiles and then the generated tiles feed the same running
//     (m, l, acc), so the merge needs no second pass; partial accumulators
//     of the row slices are summed through shared memory at the end.
// The caller passes the layer slice cache[li] (a view, no copy). Not done
// yet: int8 / int4 prompt caches, beam and rows modes, a split along the key
// axis for small B*KVH grids (128 blocks at the 7B shape fill ~1 wave).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int TK = 128;   // keys per tile
constexpr float NEG_BIG = -1e30f;
constexpr float M_INIT = -1e29f;  // above NEG_BIG: a masked key gets p = 0
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int G>
struct Smem {
  float p[G][TK];        // logits, then probabilities, of the current tile
  int ok[TK];            // key visible
  float alpha[G];        // rescale of the running accumulator for this tile
  float m[G], l[G];      // running max (exp2 domain) and denominator
  float red[NT / (D / 2)][G][D];  // final sum over the row slices
};

// One span of keys (the prompt cache or the gen cache) merged into the
// running softmax state. Exactly one of seg32 / valid8 is non-null.
template <int D, int G>
__device__ __forceinline__ void attend_span(const __nv_bfloat16* __restrict__ K,
                            const __nv_bfloat16* __restrict__ V, int S,
                            const int* __restrict__ seg32,
                            const uint8_t* __restrict__ valid8,
                            const float (&qreg)[G][8], float (&acc)[G][2],
                            Smem<D, G>& sm) {
  constexpr int LPR = D / 8;        // lanes per key row (16 bytes each)
  constexpr int RPP = NT / LPR;     // key rows per pass
  constexpr int DP = D / 2;         // bf16 pairs per row
  constexpr int JG = NT / DP;       // row slices of the PV pass
  const int tid = threadIdx.x;
  const int lr = tid % LPR, rr = tid / LPR;
  const int dp = tid % DP, jg = tid / DP;
  const int warp = tid >> 5, lane = tid & 31;

  for (int c0 = 0; c0 < S; c0 += TK) {
    // logits of the tile's visible keys
#pragma unroll
    for (int r = rr; r < TK; r += RPP) {
      const int j = c0 + r;
      const bool ok = j < S && (seg32 ? seg32[j] != 0 : valid8[j] != 0);
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (ok) {
        const uint4 kx =
            *reinterpret_cast<const uint4*>(K + (long)j * D + lr * 8);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 kf = __bfloat1622float2(k2[i]);
#pragma unroll
          for (int g = 0; g < G; ++g)
            part[g] += qreg[g][2 * i] * kf.x + qreg[g][2 * i + 1] * kf.y;
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lr == 0) {
        sm.ok[r] = ok;
#pragma unroll
        for (int g = 0; g < G; ++g) sm.p[g][r] = ok ? part[g] : NEG_BIG;
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head of the group
    if (warp < G) {
      const int g = warp;
      float mx = M_INIT;
      for (int i = lane; i < TK; i += 32) mx = fmaxf(mx, sm.p[g][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < TK; i += 32) {
        const float p = exp2f(sm.p[g][i] - m_new);
        sm.p[g][i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float al = exp2f(m_old - m_new);
        sm.alpha[g] = al;
        sm.l[g] = sm.l[g] * al + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's slice of the tile's rows
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g][0] *= sm.alpha[g];
      acc[g][1] *= sm.alpha[g];
    }
    const int rows = min(TK, S - c0);
#pragma unroll 4
    for (int r = jg; r < rows; r += JG) {
      if (!sm.ok[r]) continue;  // same branch for every thread of the row
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(V + (long)(c0 + r) * D +
                                                   dp * 2));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sm.p[g][r];
        acc[g][0] += p * vf.x;
        acc[g][1] += p * vf.y;
      }
    }
    __syncthreads();  // the next tile overwrites p and ok
  }
}

template <int D, int G>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp,
                   const int* __restrict__ seg,
                   const __nv_bfloat16* __restrict__ kg,
                   const __nv_bfloat16* __restrict__ vg,
                   const uint8_t* __restrict__ gvalid,
                   __nv_bfloat16* __restrict__ o, int H, int KVH, int Sp,
                   int Sg, float scale_log2) {
  constexpr int LPR = D / 8;
  constexpr int DP = D / 2;
  constexpr int JG = NT / DP;
  __shared__ Smem<D, G> sm;
  const int n = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;

  // this thread's 8 dims of each query head, pre-scaled into the exp2 domain
  float qreg[G][8];
  const int lr = tid % LPR;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 qx = *reinterpret_cast<const uint4*>(
        q + ((long)b * H + n * G + g) * D + lr * 8);
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(q2[i]);
      qreg[g][2 * i] = f.x * scale_log2;
      qreg[g][2 * i + 1] = f.y * scale_log2;
    }
  }
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  if (tid < G) {
    sm.m[tid] = M_INIT;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  const long head = (long)b * KVH + n;
  attend_span<D, G>(kp + head * Sp * D, vp + head * Sp * D, Sp,
                    seg + (long)b * Sp, nullptr, qreg, acc, sm);
  attend_span<D, G>(kg + head * Sg * D, vg + head * Sg * D, Sg, nullptr,
                    gvalid + (long)b * Sg, qreg, acc, sm);

  const int dp = tid % DP, jg = tid / DP;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sm.red[jg][g][2 * dp] = acc[g][0];
    sm.red[jg][g][2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < JG; ++j) s += sm.red[j][g][d];
    const float l = sm.l[g];
    o[((long)b * H + n * G + g) * D + d] =
        __float2bfloat16(l > 0.f ? s / l : 0.f);
  }
}

template <int D>
int launch_d(int G, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
             const __nv_bfloat16* kp, const __nv_bfloat16* vp, const int* seg,
             const __nv_bfloat16* kg, const __nv_bfloat16* vg,
             const uint8_t* gv, __nv_bfloat16* o, int H, int KVH, int Sp,
             int Sg, float sl2) {
  switch (G) {
    case 1:
      decode_attn_kernel<D, 1><<<grid, NT, 0, st>>>(q, kp, vp, seg, kg, vg,
                                                    gv, o, H, KVH, Sp, Sg, sl2);
      break;
    case 2:
      decode_attn_kernel<D, 2><<<grid, NT, 0, st>>>(q, kp, vp, seg, kg, vg,
                                                    gv, o, H, KVH, Sp, Sg, sl2);
      break;
    case 4:
      decode_attn_kernel<D, 4><<<grid, NT, 0, st>>>(q, kp, vp, seg, kg, vg,
                                                    gv, o, H, KVH, Sp, Sg, sl2);
      break;
    case 8:
      decode_attn_kernel<D, 8><<<grid, NT, 0, st>>>(q, kp, vp, seg, kg, vg,
                                                    gv, o, H, KVH, Sp, Sg, sl2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D) bf16; kp/vp (B, KVH, Sp, D) bf16; seg (B, Sp) int32;
// kg/vg (B, KVH, Sg, D) bf16; gvalid (B, Sg) bool; o (B, H, D) bf16.
// Returns a cudaError_t.
extern "C" int halva_decode_attn_bf16(const void* q, const void* kp,
                                      const void* vp, const void* seg,
                                      const void* kg, const void* vg,
                                      const void* gvalid, void* o, int B,
                                      int H, int KVH, int Sp, int Sg, int D,
                                      float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || Sp < 0 || Sg < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(KVH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  const float sl2 = scale * LOG2E;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kpp = static_cast<const __nv_bfloat16*>(kp);
  const auto* vpp = static_cast<const __nv_bfloat16*>(vp);
  const auto* sp = static_cast<const int*>(seg);
  const auto* kgp = static_cast<const __nv_bfloat16*>(kg);
  const auto* vgp = static_cast<const __nv_bfloat16*>(vg);
  const auto* gvp = static_cast<const uint8_t*>(gvalid);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D != 128)  // the head dim of every supported Llama config
    return (int)cudaErrorInvalidValue;
  return launch_d<128>(G, grid, st, qp, kpp, vpp, sp, kgp, vgp, gvp, op, H,
                       KVH, Sp, Sg, sl2);
}
