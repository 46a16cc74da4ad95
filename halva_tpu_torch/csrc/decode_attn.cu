// K4: one-query decode attention over a layer's prompt KV cache merged with
// its generated-token cache in one softmax, GQA grouped; bf16, int8 or
// nibble-packed int4 prompt caches, bf16 or int8 gen caches.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/decode_attention.py:
// _decode_kernel (pallas_call in decode_attend_layer), in its bf16, int8 and
// int4 prompt modes with bf16 or int8 gen caches. Same contract: prompt token
// t is visible iff t < Sp and prompt_seg[b, t] != 0 (Sp the true prompt
// length), gen slot j iff gen_valid[b, j]; the G = H / KVH query heads of kv
// head n are heads n*G .. n*G+G-1; a row with no visible key comes out as 0.
// Cache formats (one template instance per (prompt, gen) pair in use:
// bf16/bf16, int8/int8, int4/int8):
//   - bf16: (B, KVH, S, D) values;
//   - int8: (B, KVH, S, D) int8 values, per-(token, head) bf16 scales
//     (B, KVH, S). Values convert without their scale; the k scale
//     multiplies the logit and the v scale the probability before the PV
//     product (as the Pallas kernel and llama._decode_attend);
//   - int4: (B, KVH, ceil(Sp/2), D) int8, byte row r holding token 2r in its
//     low nibble and token 2r+1 in its high nibble, sign-extended by an
//     arithmetic shift of a 32-bit value; scales (B, 2, KVH, ceil(Sp/2)),
//     the even/odd plane ahead of the heads.
// A masked key is selected out, never multiplied: its logit is -1e30, its
// v scale 0 and its V row unread, whatever its scale holds.
//
// What bounds it on an H100: memory bandwidth. Per call it reads the layer's
// caches once (bf16 at llava-1.5-7b B=4, Sp=623, Sg=128: 49 MB; int4 prompt
// + int8 gen: ~11 MB), at ~G FLOP per byte: far below the ridge, so bytes
// are the whole cost. The design streams each cache row exactly once and
// skips rows that are masked:
//   - one block of 256 threads per (kv head, batch row) carries all G query
//     heads of that kv head, so a key or value row is read once for G heads
//     (the reference's grouped GQA, with no repeated cache);
//   - keys arrive in tiles of 128 tokens; D/8 lanes per row, each loading 8
//     dims (16 bytes bf16, 8 bytes int8/int4; the two tokens of an int4 byte
//     row are adjacent rows of the tile, so their loads coalesce), the dot
//     products reduced with warp shuffles into shared logits;
//   - one warp per head runs the online softmax (exp2 domain, fp32) over a
//     tile; the PV pass has each thread own two adjacent dims of a slice of
//     the tile's rows, so a warp's value loads are contiguous;
//   - the prompt tiles and then the generated tiles feed the same running
//     (m, l, acc), so the merge needs no second pass; partial accumulators
//     of the row slices are summed through shared memory at the end.
// The caller passes the layer slice cache[li] (a view, no copy). Beam mode
// (beam_k > 1, the reference's grid route): q, o, the gen cache and gen_valid
// carry B * beam_k rows and row r reads prompt row r / beam_k, so the prompt
// cache is stored once per item; each beam's block still streams it (the L2
// may serve the repeats). fold_attn.cu reads it once per item instead. The
// reference's rows mode is the same function as the base modes: how many
// rows a block takes is this kernel's own tiling. Not done yet: a split
// along the key axis for small B*KVH grids (128 blocks at the 7B shape fill
// ~1 wave).

#include "decode_common.cuh"

namespace {

using namespace halva_decode;

// PF / GF: prompt and gen cache formats. Sp is the true prompt length in
// tokens, sp_rows the prompt cache's rows per head (Sp, or ceil(Sp/2) for
// int4).
template <int D, int G, int PF, int GF>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const void* __restrict__ kp, const void* __restrict__ vp,
                   const __nv_bfloat16* __restrict__ kps,
                   const __nv_bfloat16* __restrict__ vps,
                   const int* __restrict__ seg,
                   const void* __restrict__ kg, const void* __restrict__ vg,
                   const __nv_bfloat16* __restrict__ kgs,
                   const __nv_bfloat16* __restrict__ vgs,
                   const uint8_t* __restrict__ gvalid,
                   __nv_bfloat16* __restrict__ o, int H, int KVH, int Sp,
                   int sp_rows, int Sg, int beam_k, float scale_log2) {
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

  // beam mode: rows b of q, o and the gen cache are beams, beam_k per item;
  // the prompt cache, its scales and segment ids stay at item rows
  const int bp = b / beam_k;
  const long head = (long)b * KVH + n;
  const long phead = (long)bp * KVH + n;
  Span ps;
  ps.k = static_cast<const char*>(kp) + phead * sp_rows * row_bytes<PF>(D);
  ps.v = static_cast<const char*>(vp) + phead * sp_rows * row_bytes<PF>(D);
  if (PF == I4) {  // (B, 2, KVH, sp_rows): even plane, odd plane behind it
    ps.ks = kps + ((long)bp * 2 * KVH + n) * sp_rows;
    ps.vs = vps + ((long)bp * 2 * KVH + n) * sp_rows;
    ps.odd = (long)KVH * sp_rows;
  } else {
    ps.ks = kps ? kps + phead * Sp : nullptr;
    ps.vs = vps ? vps + phead * Sp : nullptr;
    ps.odd = 0;
  }
  ps.stride = D;
  ps.S = Sp;
  ps.seg = seg + (long)bp * Sp;
  ps.valid = nullptr;
  ps.row_lo = 0;
  ps.row_hi = G;
  ps.causal_g = 0;
  ps.row0 = 0;
  attend_span<D, G, PF>(ps, qreg, acc, sm);

  Span gs;
  gs.k = static_cast<const char*>(kg) + head * Sg * row_bytes<GF>(D);
  gs.v = static_cast<const char*>(vg) + head * Sg * row_bytes<GF>(D);
  gs.ks = kgs ? kgs + head * Sg : nullptr;
  gs.vs = vgs ? vgs + head * Sg : nullptr;
  gs.odd = 0;
  gs.stride = D;
  gs.S = Sg;
  gs.seg = nullptr;
  gs.valid = gvalid + (long)b * Sg;
  gs.row_lo = 0;
  gs.row_hi = G;
  gs.causal_g = 0;
  gs.row0 = 0;
  attend_span<D, G, GF>(gs, qreg, acc, sm);

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

struct Args {
  const __nv_bfloat16* q;
  const void *kp, *vp;
  const __nv_bfloat16 *kps, *vps;
  const int* seg;
  const void *kg, *vg;
  const __nv_bfloat16 *kgs, *vgs;
  const uint8_t* gv;
  __nv_bfloat16* o;
  int H, KVH, Sp, sp_rows, Sg, beam_k;
  float sl2;
};

template <int D, int PF, int GF>
int launch(int G, dim3 grid, cudaStream_t st, const Args& a) {
#define HALVA_DECODE_CASE(GG)                                               \
  case GG:                                                                  \
    decode_attn_kernel<D, GG, PF, GF><<<grid, NT, 0, st>>>(                 \
        a.q, a.kp, a.vp, a.kps, a.vps, a.seg, a.kg, a.vg, a.kgs, a.vgs,     \
        a.gv, a.o, a.H, a.KVH, a.Sp, a.sp_rows, a.Sg, a.beam_k, a.sl2);     \
    break;
  switch (G) {
    HALVA_DECODE_CASE(1)
    HALVA_DECODE_CASE(2)
    HALVA_DECODE_CASE(4)
    HALVA_DECODE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HALVA_DECODE_CASE
  return (int)cudaGetLastError();
}

template <int PF, int GF>
int run(const Args& a, int B, int D, float scale, void* stream) {
  if (B <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.Sp < 0 || a.Sg < 0 ||
      a.beam_k < 1 || B % a.beam_k != 0 ||
      D != 128)  // the head dim of every supported Llama config
    return (int)cudaErrorInvalidValue;
  Args b = a;
  b.sl2 = scale * LOG2E;
  return launch<128, PF, GF>(a.H / a.KVH, dim3(a.KVH, B),
                             static_cast<cudaStream_t>(stream), b);
}

}  // namespace

// q (B, H, D) bf16; kp/vp (B / beam_k, KVH, Sp, D) bf16; seg (B / beam_k, Sp)
// int32; kg/vg (B, KVH, Sg, D) bf16; gvalid (B, Sg) bool; o (B, H, D) bf16.
// beam_k = 1: one prompt row per query row; beam_k > 1: query row r reads
// prompt row r / beam_k. Returns a cudaError_t.
extern "C" int halva_decode_attn_bf16(const void* q, const void* kp,
                                      const void* vp, const void* seg,
                                      const void* kg, const void* vg,
                                      const void* gvalid, void* o, int B,
                                      int H, int KVH, int Sp, int Sg, int D,
                                      int beam_k, float scale, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q), kp, vp, nullptr,
               nullptr, static_cast<const int*>(seg), kg, vg, nullptr,
               nullptr, static_cast<const uint8_t*>(gvalid),
               static_cast<__nv_bfloat16*>(o), H, KVH, Sp, Sp, Sg, beam_k,
               0.f};
  return run<BF16, BF16>(a, B, D, scale, stream);
}

// int8 prompt and gen caches: kp/vp (B, KVH, Sp, D) int8 with kps/vps
// (B, KVH, Sp) bf16; kg/vg (B, KVH, Sg, D) int8 with kgs/vgs (B, KVH, Sg).
extern "C" int halva_decode_attn_kv8(
    const void* q, const void* kp, const void* vp, const void* kps,
    const void* vps, const void* seg, const void* kg, const void* vg,
    const void* kgs, const void* vgs, const void* gvalid, void* o, int B,
    int H, int KVH, int Sp, int Sg, int D, int beam_k, float scale,
    void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q), kp, vp,
               static_cast<const __nv_bfloat16*>(kps),
               static_cast<const __nv_bfloat16*>(vps),
               static_cast<const int*>(seg), kg, vg,
               static_cast<const __nv_bfloat16*>(kgs),
               static_cast<const __nv_bfloat16*>(vgs),
               static_cast<const uint8_t*>(gvalid),
               static_cast<__nv_bfloat16*>(o), H, KVH, Sp, Sp, Sg, beam_k,
               0.f};
  return run<I8, I8>(a, B, D, scale, stream);
}

// int4 prompt cache and int8 gen cache: kp/vp (B, KVH, Sp2, D) int8 packed
// token pairs with kps/vps (B, 2, KVH, Sp2) bf16, Sp2 = ceil(Sp / 2), seg
// (B, Sp) in token order; the gen cache as for halva_decode_attn_kv8.
extern "C" int halva_decode_attn_kv4(
    const void* q, const void* kp, const void* vp, const void* kps,
    const void* vps, const void* seg, const void* kg, const void* vg,
    const void* kgs, const void* vgs, const void* gvalid, void* o, int B,
    int H, int KVH, int Sp, int Sp2, int Sg, int D, int beam_k, float scale,
    void* stream) {
  if (Sp2 != (Sp + 1) / 2) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), kp, vp,
               static_cast<const __nv_bfloat16*>(kps),
               static_cast<const __nv_bfloat16*>(vps),
               static_cast<const int*>(seg), kg, vg,
               static_cast<const __nv_bfloat16*>(kgs),
               static_cast<const __nv_bfloat16*>(vgs),
               static_cast<const uint8_t*>(gvalid),
               static_cast<__nv_bfloat16*>(o), H, KVH, Sp, Sp2, Sg, beam_k,
               0.f};
  return run<I4, I8>(a, B, D, scale, stream);
}
