// K5: folded multi-query decode attention. The K queries of one item (K
// beams, or the K candidate positions of a speculative verify step) attend
// the item's prompt KV cache in one pass, then their generated-token keys,
// all in one online softmax per query row.
//
// Replaces the Pallas TPU kernel halva_tpu/ops/decode_attention.py:
// _fold_kernel (pallas_call in fold_attend_layer). Same contract:
//   - q, o (B, K, H, D) bf16; the prompt cache, its scales and segment ids at
//     B item rows in the three formats of decode_attn.cu (bf16; int8 with
//     per-token scales; nibble-packed int4 token pairs with even/odd scale
//     planes); prompt token t is visible iff t < Sp and seg[b, t] != 0;
//   - per-beam gen stage (shared_gen = 0, beam search): the gen cache and
//     gen_valid carry B*K rows, and the queries of beam j attend gen row
//     b*K + j only, under its own validity;
//   - shared gen stage (shared_gen = 1, speculative verify): one gen cache row
//     per item under the item's validity, then the K fresh candidate keys and
//     values kc, vc (B, K, KVH, D) bf16, which are never read from the cache:
//     query i attends candidates j <= i;
//   - int8 scales multiply the logit (k) and the probability (v); a key that
//     is not visible is selected out, whatever its scale holds; a query row
//     with no visible key comes out as 0.
//
// What bounds it on an H100: memory bandwidth. The prompt cache is the bulk of
// the bytes (bf16 at llava-1.5-7b, B=4, Sp=623: 41 MB per layer) and the work
// per byte is K*G FLOP, far below the ridge. The TPU kernel folds the K*G
// query rows into one matrix-unit pass because a 1-row dot wastes that unit;
// what carries over to this card is only the consequence: each prompt K/V row
// leaves device memory once per item, not once per beam. The design:
//   - one block of 256 threads per (kv head, item) carries R = K*G query rows
//     in registers (8 dims of each row per thread) and streams the spans of
//     keys through decode_common.cuh's attend_span: the prompt, then either
//     each beam's gen cache under a row mask or the shared gen cache and the
//     candidates under a causal mask, all into the same running (m, l, acc);
//   - R is padded up to 2, 4 or 8 (one template instance each); R > 8 (GQA
//     with many beams) is cut into chunks of 8 rows, one block per chunk on
//     grid.z, and only then is the item's cache read by more than one block;
//   - the output is written straight into its (B, K, H, D) place, so the
//     reference's fold and un-fold transposes have no counterpart.
// Not done yet: a split along the key axis (128 blocks at the 7B shape fill
// about one wave), tensor-core dots for the R = 8 case.

#include "decode_common.cuh"

namespace {

using namespace halva_decode;

struct FoldArgs {
  const __nv_bfloat16* q;
  const void *kp, *vp;
  const __nv_bfloat16 *kps, *vps;
  const int* seg;
  const void *kg, *vg;
  const __nv_bfloat16 *kgs, *vgs;
  const uint8_t* gv;
  const __nv_bfloat16 *kc, *vc;
  __nv_bfloat16* o;
  int K, G, H, KVH, Sp, sp_rows, Sg, shared_gen;
  float sl2;
};

// R: query rows per block (row i of the block is row r = row0 + i of the
// item's K*G rows; r = beam * G + g, the query head being n * G + g).
template <int D, int R, int PF, int GF>
__global__ void __launch_bounds__(NT) fold_attn_kernel(const FoldArgs a) {
  constexpr int LPR = D / 8;
  constexpr int DP = D / 2;
  constexpr int JG = NT / DP;
  __shared__ Smem<D, R> sm;
  const int n = blockIdx.x, b = blockIdx.y;
  const int row0 = blockIdx.z * R;
  const int rows = a.K * a.G;
  const int live = min(R, rows - row0);  // real rows of this block
  const int tid = threadIdx.x;
  const int K = a.K, G = a.G, H = a.H, KVH = a.KVH;

  float qreg[R][8];
  const int lr = tid % LPR;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    if (i < live) {
      const int sub = r / G, g = r % G;
      const uint4 qx = *reinterpret_cast<const uint4*>(
          a.q + (((long)b * K + sub) * H + n * G + g) * D + lr * 8);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(q2[j]);
        qreg[i][2 * j] = f.x * a.sl2;
        qreg[i][2 * j + 1] = f.y * a.sl2;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qreg[i][j] = 0.f;
    }
  }
  float acc[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = 0.f;
  if (tid < R) {
    sm.m[tid] = M_INIT;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  // the prompt: every row of the block
  const long phead = (long)b * KVH + n;
  Span ps;
  ps.k = static_cast<const char*>(a.kp) +
         phead * a.sp_rows * row_bytes<PF>(D);
  ps.v = static_cast<const char*>(a.vp) +
         phead * a.sp_rows * row_bytes<PF>(D);
  if (PF == I4) {  // (B, 2, KVH, sp_rows): even plane, odd plane behind it
    ps.ks = a.kps + ((long)b * 2 * KVH + n) * a.sp_rows;
    ps.vs = a.vps + ((long)b * 2 * KVH + n) * a.sp_rows;
    ps.odd = (long)KVH * a.sp_rows;
  } else {
    ps.ks = a.kps ? a.kps + phead * a.Sp : nullptr;
    ps.vs = a.vps ? a.vps + phead * a.Sp : nullptr;
    ps.odd = 0;
  }
  ps.stride = D;
  ps.S = a.Sp;
  ps.seg = a.seg + (long)b * a.Sp;
  ps.valid = nullptr;
  ps.row_lo = 0;
  ps.row_hi = live;
  ps.causal_g = 0;
  ps.row0 = row0;
  attend_span<D, R, PF>(ps, qreg, acc, sm);

  // the generated tokens: one shared cache row, or one row per beam
  const int sub_lo = a.shared_gen ? 0 : row0 / G;
  const int sub_hi = a.shared_gen ? 0 : (row0 + live - 1) / G;
  for (int sub = sub_lo; sub <= sub_hi; ++sub) {
    const long grow = a.shared_gen ? (long)b : (long)b * K + sub;
    const long ghead = grow * KVH + n;
    Span gs;
    gs.k = static_cast<const char*>(a.kg) + ghead * a.Sg * row_bytes<GF>(D);
    gs.v = static_cast<const char*>(a.vg) + ghead * a.Sg * row_bytes<GF>(D);
    gs.ks = a.kgs ? a.kgs + ghead * a.Sg : nullptr;
    gs.vs = a.vgs ? a.vgs + ghead * a.Sg : nullptr;
    gs.odd = 0;
    gs.stride = D;
    gs.S = a.Sg;
    gs.seg = nullptr;
    gs.valid = a.gv + grow * a.Sg;
    gs.row_lo = a.shared_gen ? 0 : max(0, sub * G - row0);
    gs.row_hi = a.shared_gen ? live : min(live, (sub + 1) * G - row0);
    gs.causal_g = 0;
    gs.row0 = row0;
    attend_span<D, R, GF>(gs, qreg, acc, sm);
  }

  // the fresh candidates (B, K, KVH, D): token j of the span is candidate j,
  // visible to the queries of candidates i >= j
  if (a.kc != nullptr) {
    Span cs;
    cs.k = a.kc + ((long)b * K * KVH + n) * D;
    cs.v = a.vc + ((long)b * K * KVH + n) * D;
    cs.ks = nullptr;
    cs.vs = nullptr;
    cs.odd = 0;
    cs.stride = (long)KVH * D;
    cs.S = K;
    cs.seg = nullptr;
    cs.valid = nullptr;
    cs.row_lo = 0;
    cs.row_hi = live;
    cs.causal_g = G;
    cs.row0 = row0;
    attend_span<D, R, BF16>(cs, qreg, acc, sm);
  }

  const int dp = tid % DP, jg = tid / DP;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    sm.red[jg][i][2 * dp] = acc[i][0];
    sm.red[jg][i][2 * dp + 1] = acc[i][1];
  }
  __syncthreads();
  for (int e = tid; e < live * D; e += NT) {
    const int i = e / D, d = e % D;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < JG; ++j) s += sm.red[j][i][d];
    const float l = sm.l[i];
    const int r = row0 + i;
    const int sub = r / G, g = r % G;
    a.o[(((long)b * K + sub) * H + n * G + g) * D + d] =
        __float2bfloat16(l > 0.f ? s / l : 0.f);
  }
}

template <int D, int PF, int GF>
int launch(const FoldArgs& a, int B, cudaStream_t st) {
  const int rows = a.K * a.G;
  const int R = rows <= 2 ? 2 : (rows <= 4 ? 4 : 8);
  const dim3 grid(a.KVH, B, (rows + R - 1) / R);
  if (R == 2)
    fold_attn_kernel<D, 2, PF, GF><<<grid, NT, 0, st>>>(a);
  else if (R == 4)
    fold_attn_kernel<D, 4, PF, GF><<<grid, NT, 0, st>>>(a);
  else
    fold_attn_kernel<D, 8, PF, GF><<<grid, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = bf16 prompt and gen caches (kps, vps, kgs, vgs null), 1 = int8
// prompt and gen caches, 2 = int4 prompt cache (sp_rows = ceil(Sp / 2)) and
// int8 gen cache. q, o (B, K, H, D) bf16; kp/vp (B, KVH, sp_rows, D); seg
// (B, Sp) int32; kg/vg (B*K or B, KVH, Sg, D); gvalid (B*K or B, Sg) bool;
// kc/vc (B, K, KVH, D) bf16 or null (then no candidate stage). Returns a
// cudaError_t.
extern "C" int halva_fold_attn(int fmt, const void* q, const void* kp,
                               const void* vp, const void* kps,
                               const void* vps, const void* seg,
                               const void* kg, const void* vg,
                               const void* kgs, const void* vgs,
                               const void* gvalid, const void* kc,
                               const void* vc, void* o, int B, int K, int H,
                               int KVH, int Sp, int sp_rows, int Sg, int D,
                               int shared_gen, float scale, void* stream) {
  if (B <= 0 || K < 1 || KVH <= 0 || H % KVH != 0 || Sp < 0 || Sg < 0 ||
      D != 128 || (kc == nullptr) != (vc == nullptr) ||
      sp_rows != (fmt == 2 ? (Sp + 1) / 2 : Sp))
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  if (G != 1 && G != 2 && G != 4 && G != 8)
    return (int)cudaErrorInvalidValue;
  const FoldArgs a{static_cast<const __nv_bfloat16*>(q),
                   kp,
                   vp,
                   static_cast<const __nv_bfloat16*>(kps),
                   static_cast<const __nv_bfloat16*>(vps),
                   static_cast<const int*>(seg),
                   kg,
                   vg,
                   static_cast<const __nv_bfloat16*>(kgs),
                   static_cast<const __nv_bfloat16*>(vgs),
                   static_cast<const uint8_t*>(gvalid),
                   static_cast<const __nv_bfloat16*>(kc),
                   static_cast<const __nv_bfloat16*>(vc),
                   static_cast<__nv_bfloat16*>(o),
                   K,
                   G,
                   H,
                   KVH,
                   Sp,
                   sp_rows,
                   Sg,
                   shared_gen,
                   scale * halva_decode::LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0:
      return launch<128, halva_decode::BF16, halva_decode::BF16>(a, B, st);
    case 1:
      return launch<128, halva_decode::I8, halva_decode::I8>(a, B, st);
    case 2:
      return launch<128, halva_decode::I4, halva_decode::I8>(a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
