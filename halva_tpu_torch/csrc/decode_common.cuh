// Device code of the decode-attention kernels: the cache formats and nibble
// and byte conversions (decode_attn.cu, fold_attn.cu), cache-row loads in
// the three formats, and `attend_span` (fold_attn.cu: K queries per item;
// decode_attn.cu has its own staged tile loop), which merges one span of
// keys (a prompt cache, a gen cache, or a row of fresh candidate keys) into
// a block's running online softmax for up to 8 query rows at once.
//
// A block has NT threads and carries G query rows that share their keys. Per
// tile of TK keys: D/8 lanes per key row each load 8 dims and reduce the G dot
// products with warp shuffles; one warp per query row updates its running
// (max, denominator) in the exp2 domain; then every thread owns two adjacent
// dims of a slice of the tile's rows for the PV sum. A key is visible to query
// row g iff the key is live (segment id != 0, or its valid byte set, or, with
// neither given, always), g lies in [row_lo, row_hi), and, when causal_g > 0,
// its index t <= (row0 + g) / causal_g. Whatever is not visible is selected
// out: logit -1e30, weight 0, V row unread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace halva_decode {

constexpr int NT = 256;   // threads per block
constexpr int TK = 128;   // keys per tile
constexpr float NEG_BIG = -1e30f;
constexpr float M_INIT = -1e29f;  // above NEG_BIG: a masked key gets p = 0
constexpr float LOG2E = 1.4426950408889634f;

enum Fmt { BF16 = 0, I8 = 1, I4 = 2 };

template <int D, int G>
struct Smem {
  float p[G][TK];        // logits, then probabilities, of the current tile
  int ok[TK];            // key visible
  float vsc[TK];         // v scale of a visible key, 0 for a masked one
  float alpha[G];        // rescale of the running accumulator for this tile
  float m[G], l[G];      // running max (exp2 domain) and denominator
  float red[NT / (D / 2)][G][D];  // final sum over the row slices
};

// One span of keys of one (batch row, kv head): the prompt cache, a gen
// cache, or the fresh candidate keys. At most one of seg / valid is non-null;
// with neither, every key is live.
struct Span {
  const void* k;
  const void* v;
  const __nv_bfloat16* ks;  // int8: token scales; int4: even-token plane
  const __nv_bfloat16* vs;
  long odd;                 // int4: offset of the odd-token scale plane
  long stride;              // elements (bf16) or bytes between cache rows
  int S;                    // tokens
  const int* seg;
  const uint8_t* valid;
  int row_lo, row_hi;       // query rows of the block that see this span
  int causal_g, row0;       // > 0: row g sees token t <= (row0 + g) / causal_g
};

// signed nibble (low if sh == 0, high if sh == 4) of byte j of w
__device__ __forceinline__ float nib(uint32_t w, int j, int sh) {
  return (float)((int32_t)(w << (28 - 8 * j - sh)) >> 28);
}

__device__ __forceinline__ float sbyte(uint32_t w, int j) {
  return (float)((int32_t)(w << (24 - 8 * j)) >> 24);
}

// dims lr*8 .. lr*8+7 of key token t, unscaled
template <int D, int F>
__device__ __forceinline__ void load_k8(const Span& s, int t, int lr,
                                        float (&kf)[8]) {
  if constexpr (F == BF16) {
    const uint4 kx = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(s.k) + (long)t * s.stride + lr * 8);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(k2[i]);
      kf[2 * i] = f.x;
      kf[2 * i + 1] = f.y;
    }
  } else {
    const long row = F == I4 ? (t >> 1) : t;
    const uint2 kx = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(s.k) + row * s.stride + lr * 8);
    const int sh = (t & 1) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kf[j] = F == I4 ? nib(kx.x, j, sh) : sbyte(kx.x, j);
      kf[4 + j] = F == I4 ? nib(kx.y, j, sh) : sbyte(kx.y, j);
    }
  }
}

// dims 2*dp, 2*dp+1 of value token t, unscaled
template <int D, int F>
__device__ __forceinline__ float2 load_v2(const Span& s, int t, int dp) {
  if constexpr (F == BF16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(s.v) + (long)t * s.stride + dp * 2));
  const long row = F == I4 ? (t >> 1) : t;
  const uint32_t w = *reinterpret_cast<const uint16_t*>(
      static_cast<const int8_t*>(s.v) + row * s.stride + dp * 2);
  if constexpr (F == I4) {
    const int sh = (t & 1) * 4;
    return make_float2(nib(w, 0, sh), nib(w, 1, sh));
  }
  return make_float2(sbyte(w, 0), sbyte(w, 1));
}

template <int F>
__device__ __forceinline__ float tok_scale(const __nv_bfloat16* sc,
                                           const Span& s, int t) {
  if constexpr (F == BF16) return 1.f;
  if constexpr (F == I4)
    return __bfloat162float(sc[(t & 1) * s.odd + (t >> 1)]);
  return __bfloat162float(sc[t]);
}

// One span merged into the running softmax state.
template <int D, int G, int F>
__device__ __forceinline__ void attend_span(const Span& s,
                                            const float (&qreg)[G][8],
                                            float (&acc)[G][2],
                                            Smem<D, G>& sm) {
  constexpr int LPR = D / 8;        // lanes per key row
  constexpr int RPP = NT / LPR;     // key rows per pass
  constexpr int DP = D / 2;         // dim pairs per row
  constexpr int JG = NT / DP;       // row slices of the PV pass
  const int tid = threadIdx.x;
  const int lr = tid % LPR, rr = tid / LPR;
  const int dp = tid % DP, jg = tid / DP;
  const int warp = tid >> 5, lane = tid & 31;

  for (int c0 = 0; c0 < s.S; c0 += TK) {
    // logits of the tile's visible keys
#pragma unroll
    for (int r = rr; r < TK; r += RPP) {
      const int t = c0 + r;
      const bool ok =
          t < s.S &&
          (s.seg ? s.seg[t] != 0 : (s.valid ? s.valid[t] != 0 : true));
      // the scales are loaded before the row, so the two loads overlap
      float ksc = 0.f, vsc = 0.f;
      if (ok && lr == 0) {
        ksc = tok_scale<F>(s.ks, s, t);
        vsc = tok_scale<F>(s.vs, s, t);
      }
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (ok) {
        float kf[8];
        load_k8<D, F>(s, t, lr, kf);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += qreg[g][i] * kf[i];
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lr == 0) {
        sm.ok[r] = ok;
        sm.vsc[r] = vsc;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const bool vis =
              ok && g >= s.row_lo && g < s.row_hi &&
              (s.causal_g == 0 || t <= (s.row0 + g) / s.causal_g);
          sm.p[g][r] = vis ? part[g] * ksc : NEG_BIG;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head of the group; the
    // stored weight of a key is its probability times its v scale
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
        sm.p[g][i] = F == BF16 ? p : p * sm.vsc[i];
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
    const int rows = min(TK, s.S - c0);
#pragma unroll 4
    for (int r = jg; r < rows; r += JG) {
      if (!sm.ok[r]) continue;  // same branch for every thread of the row
      const float2 vf = load_v2<D, F>(s, c0 + r, dp);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sm.p[g][r];
        acc[g][0] += p * vf.x;
        acc[g][1] += p * vf.y;
      }
    }
    __syncthreads();  // the next tile overwrites p, ok and vsc
  }
}

template <int F>
__host__ __device__ constexpr int row_bytes(int D) {
  return F == BF16 ? 2 * D : D;
}

}  // namespace halva_decode
