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
// A masked key is selected out, never multiplied: its probability is 0 and
// its scales are never read into the result, and its K and V rows are not
// read from device memory (their shared-memory rows are zero-filled).
//
// What bounds it on an H100: latency, where bytes should. A call reads the
// layer's live cache rows once (bf16 at llava-1.5-7b B=4, Sp=623, Sg=128:
// ~45 MB, 0.0134 ms at 3.35 TB/s; int4 prompt + int8 gen ~13 MB) at ~G FLOP
// per byte, far below the ridge. The first K4 (one block per (kv head, row),
// a chain of dependent loads per 128-key tile) measured 0.0793 ms bf16 and
// 0.1196 int4: 128 blocks, one per SM, each waiting ~16 memory round trips
// per tile. The design keeps enough bytes in flight instead:
//   - the key axis is split across blocks: grid (KVH, B, splits). The
//     wrapper plans `splits` from B*KVH against the SM count
//     (ops/decode_attention.decode_plan): each split owns a contiguous range
//     of 64-key prompt tiles (so an int4 boundary falls on an even token);
//     the gen span is a split of its own; splits = 1 where B*KVH alone fills
//     the card (batch 80: 2,560 blocks);
//   - each tile's K and V rows go to shared memory by cp.async, 16 bytes a
//     thread, all issued at once into a ring of two stages, so the next
//     tile's rows are in flight while this one is reduced. A row whose keys
//     are all masked is zero-filled, not read. The per-token arrays (segment
//     ids or valid bytes, scales: not 16-byte aligned in general, a row of
//     623 bf16 scales) travel through registers one tile ahead of the rows
//     and are stored in a ring of three metadata slots, which the row copies
//     consult; a tile with no visible key is skipped;
//   - per tile: 16 lanes per cache row reduce the G dot products (8 dims a
//     lane, warp shuffles), one warp per query head runs the online softmax
//     in the exp2 domain (fp32), then each warp takes every 8th row of the
//     tile for the PV sum, a lane owning 4 dims (an 8-byte bf16 or 4-byte
//     int8/int4 read from shared memory, both tokens of an int4 byte row at
//     once). Three barriers per 64-key tile;
//   - the splits merge in the same launch: each split writes its fp32
//     partial (running max in the exp2 domain, denominator, unnormalised
//     G x D accumulator) to scratch, and the last block of a (kv head, row)
//     to take its ticket (atomicAdd after __threadfence, as dq_gemm.cu) sums
//     the partials in split order and writes o, then resets the ticket: no
//     float atomics, bitwise-equal output from call to call, capturable in a
//     CUDA graph. A split with no visible key has max -1e29 and denominator
//     0: its weight 2^(m_s - M) is 0, and with every split empty the output
//     is 0. With splits = 1 the block writes o itself.
// A second combine kernel would add ~19 us of host time per layer to every
// decode step (the steps are host-bound), hence the single launch.
// The caller passes the layer slice cache[li] (a view, no copy). Beam mode
// (beam_k > 1, the reference's grid route): q, o, the gen cache and gen_valid
// carry B * beam_k rows and row r reads prompt row r / beam_k, so the prompt
// cache is stored once per item; each beam's blocks still stream it (the L2
// may serve the repeats). fold_attn.cu reads it once per item instead. The
// reference's rows mode is the same function as the base modes.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, device ms
// from CUDA-graph replays, B=4 Sp=623 Sg=128 H=KVH=32; first design in
// brackets): bf16 0.0241 (0.0793; SDPA over the same keys 0.0309, byte
// bound 0.0134), int8/int8 0.0197 (0.0837; bound 0.0068), int4/int8 0.0173
// (0.1196; bound 0.0038), all at 4 splits; the beam mode at 16 rows, 1
// split, 0.0628 / 0.0466 / 0.0433 (0.0804 / 0.0800 / 0.1168); int4/int8 at
// batch 80, 1 split, 0.1907 (0.4911 in the same call; bound 0.0754). What
// it waits on now: at B=4 the bf16 call streams the live rows at ~1.86
// TB/s, the int4 one at ~0.73 TB/s; a block's first tile costs a whole
// memory latency before any compute, and a split holds only 2-4 tiles, so
// the launch, that first latency and the merge are most of an int4 call.

#include "decode_common.cuh"

namespace {

using halva_decode::BF16;
using halva_decode::BF16_ONE;
using halva_decode::bf16_bits;
using halva_decode::cp_async16;
using halva_decode::cp_async_commit;
using halva_decode::cp_async_wait_all;
using halva_decode::I4;
using halva_decode::I8;
using halva_decode::LOG2E;
using halva_decode::M_INIT;
using halva_decode::NT;
using halva_decode::nib;
using halva_decode::row_bytes;
using halva_decode::sbyte;

constexpr int D = 128;              // head dim of every supported Llama config
constexpr int TILE = 64;            // keys per tile (int4: 32 byte rows)
constexpr int WARPS = NT / 32;
constexpr int LPR = 16;             // logit lanes per cache row, 8 dims each
constexpr int RPP = NT / LPR;       // cache rows per logit pass
static_assert(TILE == 64, "the softmax takes two keys per lane");

template <int F>
__host__ __device__ constexpr int tile_rows() {
  return F == I4 ? TILE / 2 : TILE;
}

template <int F>
__host__ __device__ constexpr int tile_bytes() {
  return tile_rows<F>() * row_bytes<F>(D);
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// One (row, kv head)'s cache of one kind: the prompt or the gen cache.
struct Keys {
  const char* k;
  const char* v;
  const uint16_t* ks;  // int8: token scales; int4: even-token plane
  const uint16_t* vs;
  long odd;            // int4: offset of the odd-token scale plane
  int S;               // tokens
  const int* seg;      // prompt: segment ids
  const uint8_t* valid;  // gen: valid bytes
};

// per-token metadata of one tile in shared memory; a masked key has ok 0
// and scales 0
struct Meta {
  float ksc[TILE];
  float vsc[TILE];
  uint8_t ok[TILE];
};

template <int G>
struct Shared {        // behind the K/V ring
  Meta meta[3];
  float s[G][TILE];    // logits of the current tile (exp2 domain)
  float pw[TILE][G];   // probability times v scale of each key
  float alpha[G], m[G], l[G];
  int last;
};

// one thread's token of a tile: fetched one tile ahead, stored later
struct MetaRegs {
  int live;
  uint16_t ks, vs;
};

template <int F>
__device__ __forceinline__ MetaRegs meta_fetch(const Keys& s, int t0) {
  MetaRegs r{0, BF16_ONE, BF16_ONE};
  const int t = t0 + (int)threadIdx.x;
  if (threadIdx.x < TILE && t < s.S) {
    r.live = s.seg ? s.seg[t] != 0 : s.valid[t] != 0;
    if constexpr (F != BF16) {
      const long i = F == I4 ? (t & 1) * s.odd + (t >> 1) : t;
      r.ks = s.ks[i];
      r.vs = s.vs[i];
    }
  }
  return r;
}

__device__ __forceinline__ int meta_store(Meta& m, const MetaRegs& r) {
  if (threadIdx.x < TILE) {
    const int i = threadIdx.x;
    m.ok[i] = r.live != 0;
    m.ksc[i] = r.live ? bf16_bits(r.ks) : 0.f;
    m.vsc[i] = r.live ? bf16_bits(r.vs) : 0.f;
  }
  return r.live;
}

// the tile's K and V rows into one ring slot (K rows, then V rows)
template <int F>
__device__ __forceinline__ void kv_issue(const Keys& s, int t0, const Meta& m,
                                         char* dst) {
  constexpr int RB = row_bytes<F>(D);
  constexpr int CPR = RB / 16;  // 16-byte chunks per row
  constexpr int CH = tile_rows<F>() * CPR;
  const long r0 = F == I4 ? t0 / 2 : t0;
#pragma unroll
  for (int c = threadIdx.x; c < CH; c += NT) {
    const int r = c / CPR, cc = c % CPR;
    const bool live = F == I4 ? (m.ok[2 * r] | m.ok[2 * r + 1]) : m.ok[r];
    const long off = live ? (r0 + r) * RB + cc * 16 : 0;
    cp_async16(dst + r * RB + cc * 16, s.k + off, live);
    cp_async16(dst + tile_bytes<F>() + r * RB + cc * 16, s.v + off, live);
  }
}

// logits of the tile's keys times their k scale (0 for a masked key)
template <int F, int G>
__device__ __forceinline__ void logits(const char* kt, const Meta& m,
                                       const float (&qreg)[G][8],
                                       Shared<G>& sh) {
  constexpr int RB = row_bytes<F>(D);
  const int lr = threadIdx.x % LPR, rr = threadIdx.x / LPR;
#pragma unroll
  for (int r = rr; r < tile_rows<F>(); r += RPP) {
    float a[G], b[G];  // b: the odd token of an int4 byte row
#pragma unroll
    for (int g = 0; g < G; ++g) a[g] = b[g] = 0.f;
    if constexpr (F == BF16) {
      const uint4 x = *reinterpret_cast<const uint4*>(kt + r * RB + lr * 16);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(x2[i]);
#pragma unroll
        for (int g = 0; g < G; ++g)
          a[g] += qreg[g][2 * i] * f.x + qreg[g][2 * i + 1] * f.y;
      }
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(kt + r * RB + lr * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if constexpr (F == I8) {
            a[g] += qreg[g][j] * sbyte(x.x, j) +
                    qreg[g][4 + j] * sbyte(x.y, j);
          } else {
            a[g] += qreg[g][j] * nib(x.x, j, 0) +
                    qreg[g][4 + j] * nib(x.y, j, 0);
            b[g] += qreg[g][j] * nib(x.x, j, 4) +
                    qreg[g][4 + j] * nib(x.y, j, 4);
          }
        }
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], off);
        if constexpr (F == I4) b[g] += __shfl_xor_sync(0xffffffffu, b[g], off);
      }
    const int t = F == I4 ? 2 * r : r;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (lr == g) {
        sh.s[g][t] = a[g] * m.ksc[t];
        if constexpr (F == I4) sh.s[g][t + 1] = b[g] * m.ksc[t + 1];
      }
  }
}

// online softmax over the tile, one warp per query head
template <int G>
__device__ __forceinline__ void softmax(const Meta& m, Shared<G>& sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= G) return;
  const int g = warp;
  const bool ok0 = m.ok[lane], ok1 = m.ok[lane + 32];
  const float s0 = sh.s[g][lane], s1 = sh.s[g][lane + 32];
  float mx = fmaxf(ok0 ? s0 : M_INIT, ok1 ? s1 : M_INIT);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_old = sh.m[g];
  const float m_new = fmaxf(m_old, mx);
  const float p0 = ok0 ? exp2f(s0 - m_new) : 0.f;
  const float p1 = ok1 ? exp2f(s1 - m_new) : 0.f;
  sh.pw[lane][g] = p0 * m.vsc[lane];  // v scale 1 for a bf16 cache
  sh.pw[lane + 32][g] = p1 * m.vsc[lane + 32];
  float sum = p0 + p1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const float al = exp2f(m_old - m_new);
    sh.alpha[g] = al;
    sh.l[g] = sh.l[g] * al + sum;
    sh.m[g] = m_new;
  }
}

// acc = acc * alpha + P V: warp w takes rows w, w + 8, ..., a lane 4 dims
template <int F, int G>
__device__ __forceinline__ void pv(const char* vt, const Meta& m,
                                   const Shared<G>& sh, float (&acc)[G][4]) {
  constexpr int RB = row_bytes<F>(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] *= sh.alpha[g];
#pragma unroll 2
  for (int r = warp; r < tile_rows<F>(); r += WARPS) {
    if constexpr (F == I4) {
      const int t = 2 * r;
      if (!(m.ok[t] | m.ok[t + 1])) continue;  // the same for the whole warp
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(vt + r * RB + lane * 4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pe = sh.pw[t][g], po = sh.pw[t + 1][g];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[g][j] += pe * nib(w, j, 0) + po * nib(w, j, 4);
      }
    } else {
      if (!m.ok[r]) continue;
      float vf[4];
      if constexpr (F == BF16) {
        const uint2 x = *reinterpret_cast<const uint2*>(vt + r * RB + lane * 8);
        const float2 f0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x.x));
        const float2 f1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x.y));
        vf[0] = f0.x;
        vf[1] = f0.y;
        vf[2] = f1.x;
        vf[3] = f1.y;
      } else {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(vt + r * RB + lane * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) vf[j] = sbyte(w, j);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sh.pw[r][g];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] += p * vf[j];
      }
    }
  }
}

// one ring slot: a tile's K rows and V rows
template <int PF, int GF>
__host__ __device__ constexpr int slot_bytes() {
  return 2 * cmax(tile_bytes<PF>(), tile_bytes<GF>());
}

template <int G, int PF, int GF>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * slot_bytes<PF, GF>() + (int)sizeof(Shared<G>);
}

// PF / GF: prompt and gen cache formats. Sp is the true prompt length in
// tokens, sp_rows the prompt cache's rows per head (Sp, or ceil(Sp/2) for
// int4). Split z of (kv head x, row y) takes prompt tiles [z * tps,
// min((z + 1) * tps, ceil(Sp / 64))) and, if it is the last split, the gen
// tiles.
template <int G, int PF, int GF>
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
                   __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                   int* __restrict__ tickets, int H, int KVH, int Sp,
                   int sp_rows, int Sg, int beam_k, int splits, int tps,
                   float scale_log2) {
  constexpr int SLOT = slot_bytes<PF, GF>();
  static_assert(WARPS * G * D * 4 <= 2 * SLOT, "the final sum reuses the ring");
  extern __shared__ __align__(16) char smem[];
  Shared<G>& sh = *reinterpret_cast<Shared<G>*>(smem + 2 * SLOT);
  const int n = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

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
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  if (tid < G) {
    sh.m[tid] = M_INIT;
    sh.l[tid] = 0.f;
  }

  // beam mode: rows b of q, o and the gen cache are beams, beam_k per item;
  // the prompt cache, its scales and segment ids stay at item rows
  const int bp = b / beam_k;
  const long head = (long)b * KVH + n;
  const long phead = (long)bp * KVH + n;
  Keys ps, gs;
  ps.k = static_cast<const char*>(kp) + phead * sp_rows * row_bytes<PF>(D);
  ps.v = static_cast<const char*>(vp) + phead * sp_rows * row_bytes<PF>(D);
  if (PF == I4) {  // (B, 2, KVH, sp_rows): even plane, odd plane behind it
    ps.ks = reinterpret_cast<const uint16_t*>(kps) +
            ((long)bp * 2 * KVH + n) * sp_rows;
    ps.vs = reinterpret_cast<const uint16_t*>(vps) +
            ((long)bp * 2 * KVH + n) * sp_rows;
    ps.odd = (long)KVH * sp_rows;
  } else {
    ps.ks = kps ? reinterpret_cast<const uint16_t*>(kps) + phead * Sp : nullptr;
    ps.vs = vps ? reinterpret_cast<const uint16_t*>(vps) + phead * Sp : nullptr;
    ps.odd = 0;
  }
  ps.S = Sp;
  ps.seg = seg + (long)bp * Sp;
  ps.valid = nullptr;
  gs.k = static_cast<const char*>(kg) + head * Sg * row_bytes<GF>(D);
  gs.v = static_cast<const char*>(vg) + head * Sg * row_bytes<GF>(D);
  gs.ks = kgs ? reinterpret_cast<const uint16_t*>(kgs) + head * Sg : nullptr;
  gs.vs = vgs ? reinterpret_cast<const uint16_t*>(vgs) + head * Sg : nullptr;
  gs.odd = 0;
  gs.S = Sg;
  gs.seg = nullptr;
  gs.valid = gvalid + (long)b * Sg;

  // this split's tiles: np_ prompt tiles from p0, then ng gen tiles
  const int ptiles = (Sp + TILE - 1) / TILE;
  const int p0 = min(split * tps, ptiles);
  const int np_ = min(p0 + tps, ptiles) - p0;
  const int ng = split == splits - 1 ? (Sg + TILE - 1) / TILE : 0;
  const int nt = np_ + ng;
  auto start = [&](int i) {  // first token of local tile i in its span
    return i < np_ ? (p0 + i) * TILE : (i - np_) * TILE;
  };
  auto fetch = [&](int i) {
    if (i >= nt) return MetaRegs{0, BF16_ONE, BF16_ONE};
    return i < np_ ? meta_fetch<PF>(ps, start(i))
                   : meta_fetch<GF>(gs, start(i));
  };
  auto issue = [&](int i) {
    char* dst = smem + (i & 1) * SLOT;
    const Meta& m = sh.meta[i % 3];
    if (i < np_)
      kv_issue<PF>(ps, start(i), m, dst);
    else
      kv_issue<GF>(gs, start(i), m, dst);
  };

  // prologue: tile 0's metadata, then its rows; tile 1's metadata in flight
  MetaRegs r = fetch(0);
  bool live = __syncthreads_or(meta_store(sh.meta[0], r));
  if (nt > 0) issue(0);
  cp_async_commit();
  r = fetch(1);
  for (int i = 0; i < nt; ++i) {
    // tile i + 1's metadata (slot last read by tile i - 2), tile i + 2's
    // fetched, tile i's rows landed; then tile i + 1's rows go in flight
    const int ok_next = meta_store(sh.meta[(i + 1) % 3], r);
    r = fetch(i + 2);
    cp_async_wait_all();
    const bool live_next = __syncthreads_or(ok_next);
    if (i + 1 < nt) issue(i + 1);
    cp_async_commit();
    if (live) {  // the same for the whole block
      const Meta& m = sh.meta[i % 3];
      const char* kt = smem + (i & 1) * SLOT;
      if (i < np_)
        logits<PF, G>(kt, m, qreg, sh);
      else
        logits<GF, G>(kt, m, qreg, sh);
      __syncthreads();
      softmax<G>(m, sh);
      __syncthreads();
      if (i < np_)
        pv<PF, G>(kt + tile_bytes<PF>(), m, sh, acc);
      else
        pv<GF, G>(kt + tile_bytes<GF>(), m, sh, acc);
    }
    live = live_next;
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring: it holds the sum now

  // sum of the 8 warps' accumulators, in warp order
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(red + (warp * G + g) * D + lane * 4) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  __nv_bfloat16* out = o + ((long)b * H + n * G) * D;
  auto warp_sum = [&](int i) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w * G * D + i];
    return v;
  };
  if (splits == 1) {
    for (int i = tid; i < G * D; i += NT) {
      const float l = sh.l[i / D];
      out[i] = __float2bfloat16(l > 0.f ? warp_sum(i) / l : 0.f);
    }
    return;
  }
  constexpr int STRIDE = G * (D + 2);  // one split's partial: acc, m, l
  float* mine = part + (head * splits + split) * STRIDE;
  for (int i = tid; i < G * D; i += NT) mine[i] = warp_sum(i);
  if (tid < G) {
    mine[G * D + tid] = sh.m[tid];
    mine[G * D + G + tid] = sh.l[tid];
  }
  __threadfence();  // this block's partial reaches L2 before its ticket
  __syncthreads();
  if (tid == 0) sh.last = atomicAdd(&tickets[head], 1) == splits - 1;
  __syncthreads();
  if (!sh.last) return;
  const float* all = part + head * splits * STRIDE;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float mx = M_INIT;
    for (int z = 0; z < splits; ++z)
      mx = fmaxf(mx, __ldcg(all + z * STRIDE + G * D + g));
    float l = 0.f, v = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float w = exp2f(__ldcg(all + z * STRIDE + G * D + g) - mx);
      l += w * __ldcg(all + z * STRIDE + G * D + G + g);
      v += w * __ldcg(all + z * STRIDE + i);
    }
    out[i] = __float2bfloat16(l > 0.f ? v / l : 0.f);
  }
  if (tid == 0) tickets[head] = 0;
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
  float* part;
  int* tickets;
  int H, KVH, Sp, sp_rows, Sg, beam_k, splits, tps;
  float sl2;
};

// above 48 KB of dynamic shared memory needs the opt-in, once per kernel and
// device (the first launch is never inside a CUDA graph capture: the callers
// warm up first)
template <int G, int PF, int GF>
int launch_g(dim3 grid, cudaStream_t st, const Args& a) {
  static uint64_t smem_set = 0;
  constexpr int bytes = smem_bytes<G, PF, GF>();
  auto kernel = decode_attn_kernel<G, PF, GF>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set |= uint64_t(1) << dev;
  }
  kernel<<<grid, NT, bytes, st>>>(
      a.q, a.kp, a.vp, a.kps, a.vps, a.seg, a.kg, a.vg, a.kgs, a.vgs, a.gv,
      a.o, a.part, a.tickets, a.H, a.KVH, a.Sp, a.sp_rows, a.Sg, a.beam_k,
      a.splits, a.tps, a.sl2);
  return (int)cudaGetLastError();
}

template <int PF, int GF>
int run(const Args& a, int B, int D_, float scale, void* stream) {
  if (B <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.Sp < 0 || a.Sg < 0 ||
      a.beam_k < 1 || B % a.beam_k != 0 || B > 65535 || a.splits > 65535 ||
      D_ != D)
    return (int)cudaErrorInvalidValue;
  // the plan: prompt splits of tps tiles, none empty, the gen span a split
  // of its own when there is more than one split and a gen span
  const int ptiles = (a.Sp + TILE - 1) / TILE;
  const int psplits = a.splits > 1 && a.Sg > 0 ? a.splits - 1 : a.splits;
  if (a.splits < 1 || a.tps < 0 || (long)psplits * a.tps < ptiles ||
      (a.splits > 1 && ((long)(psplits - 1) * a.tps >= ptiles || !a.part ||
                        !a.tickets)))
    return (int)cudaErrorInvalidValue;
  Args b = a;
  b.sl2 = scale * LOG2E;
  const dim3 grid(a.KVH, B, a.splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.H / a.KVH) {
    case 1:
      return launch_g<1, PF, GF>(grid, st, b);
    case 2:
      return launch_g<2, PF, GF>(grid, st, b);
    case 4:
      return launch_g<4, PF, GF>(grid, st, b);
    case 8:
      return launch_g<8, PF, GF>(grid, st, b);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D) bf16; kp/vp (B / beam_k, KVH, Sp, D) bf16; seg (B / beam_k, Sp)
// int32; kg/vg (B, KVH, Sg, D) bf16; gvalid (B, Sg) bool; o (B, H, D) bf16.
// beam_k = 1: one prompt row per query row; beam_k > 1: query row r reads
// prompt row r / beam_k. The plan (splits, tps): see decode_attn_kernel;
// part: fp32 scratch of B * KVH * splits * G * (D + 2) (unused when splits
// == 1); tickets: >= B * KVH zeroed int32, left zeroed. Returns a
// cudaError_t.
extern "C" int halva_decode_attn_bf16(const void* q, const void* kp,
                                      const void* vp, const void* seg,
                                      const void* kg, const void* vg,
                                      const void* gvalid, void* o, void* part,
                                      void* tickets, int B, int H, int KVH,
                                      int Sp, int Sg, int D_, int beam_k,
                                      int splits, int tps, float scale,
                                      void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q), kp, vp, nullptr,
               nullptr, static_cast<const int*>(seg), kg, vg, nullptr,
               nullptr, static_cast<const uint8_t*>(gvalid),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(part),
               static_cast<int*>(tickets), H, KVH, Sp, Sp, Sg, beam_k,
               splits, tps, 0.f};
  return run<BF16, BF16>(a, B, D_, scale, stream);
}

// int8 prompt and gen caches: kp/vp (B, KVH, Sp, D) int8 with kps/vps
// (B, KVH, Sp) bf16; kg/vg (B, KVH, Sg, D) int8 with kgs/vgs (B, KVH, Sg).
extern "C" int halva_decode_attn_kv8(
    const void* q, const void* kp, const void* vp, const void* kps,
    const void* vps, const void* seg, const void* kg, const void* vg,
    const void* kgs, const void* vgs, const void* gvalid, void* o, void* part,
    void* tickets, int B, int H, int KVH, int Sp, int Sg, int D_, int beam_k,
    int splits, int tps, float scale, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q), kp, vp,
               static_cast<const __nv_bfloat16*>(kps),
               static_cast<const __nv_bfloat16*>(vps),
               static_cast<const int*>(seg), kg, vg,
               static_cast<const __nv_bfloat16*>(kgs),
               static_cast<const __nv_bfloat16*>(vgs),
               static_cast<const uint8_t*>(gvalid),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(part),
               static_cast<int*>(tickets), H, KVH, Sp, Sp, Sg, beam_k,
               splits, tps, 0.f};
  return run<I8, I8>(a, B, D_, scale, stream);
}

// int4 prompt cache and int8 gen cache: kp/vp (B, KVH, Sp2, D) int8 packed
// token pairs with kps/vps (B, 2, KVH, Sp2) bf16, Sp2 = ceil(Sp / 2), seg
// (B, Sp) in token order; the gen cache as for halva_decode_attn_kv8.
extern "C" int halva_decode_attn_kv4(
    const void* q, const void* kp, const void* vp, const void* kps,
    const void* vps, const void* seg, const void* kg, const void* vg,
    const void* kgs, const void* vgs, const void* gvalid, void* o, void* part,
    void* tickets, int B, int H, int KVH, int Sp, int Sp2, int Sg, int D_,
    int beam_k, int splits, int tps, float scale, void* stream) {
  if (Sp2 != (Sp + 1) / 2) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), kp, vp,
               static_cast<const __nv_bfloat16*>(kps),
               static_cast<const __nv_bfloat16*>(vps),
               static_cast<const int*>(seg), kg, vg,
               static_cast<const __nv_bfloat16*>(kgs),
               static_cast<const __nv_bfloat16*>(vgs),
               static_cast<const uint8_t*>(gvalid),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(part),
               static_cast<int*>(tickets), H, KVH, Sp, Sp2, Sg, beam_k,
               splits, tps, 0.f};
  return run<I4, I8>(a, B, D_, scale, stream);
}
