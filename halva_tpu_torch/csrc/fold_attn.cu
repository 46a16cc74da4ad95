// K5: folded multi-query decode attention. The K queries of one item (K
// beams, or the K candidate positions of a speculative verify step) attend
// the item's prompt KV cache in one pass, then their generated-token keys,
// all in one softmax per query row.
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
// What bounds it on an H100: memory bandwidth, in principle. The prompt cache
// is the bulk of the bytes (bf16 at llava-1.5-7b, B=4, Sp=623: 41 MB per
// layer) and the work per byte is K*G FLOP, far below the ridge. Each prompt
// K/V row should leave device memory once per item, not once per beam, and
// enough rows must be in flight to cover the memory latency. The first K5
// (one block per (kv head, item), a 128-key tile loop of dependent loads,
// CUDA-core dots) measured 0.0967-0.1683 ms at 5.7-34x its byte bound. The
// design, K4's (decode_attn.cu) with R = K*G query rows in place of one:
//   - work items (kv head, item, row chunk, split), grid (KVH, B * chunks,
//     splits). A block carries up to 16 query rows (r = beam * G + g), so
//     every shape up to 16 rows (Mistral's G=4 at K=4 among them) reads each
//     prompt tile once per item; above 16 rows the chunks re-read it. The
//     plan (ops/decode_attention.fold_plan) cuts the prompt into contiguous
//     ranges of 64-key tiles (an int4 boundary falls on an even token) and
//     gives the gen spans splits of their own: in the per-beam stage one per
//     beam of the chunk, where only that beam's G rows see the keys; in the
//     shared stage one for the shared gen span and the candidates. Splits = 1
//     where the work items alone fill the card (batch 80);
//   - each tile's K and V rows go to shared memory by cp.async into a ring:
//     three stages (two tiles in flight while one is read, two blocks an SM)
//     for a split plan, whose blocks hold a few tiles; two stages (three
//     blocks an SM) for a one-split plan, whose blocks hold a whole item. The
//     per-token metadata (segment ids or valid bytes, scales) travels two
//     tiles ahead through registers into four slots; tiles 0 and 1's
//     metadata and the query rows load in one round trip. A masked row is
//     zero-filled, not read, and a warp skips its 16 keys of a tile when
//     none is live. bf16 tiles land in the mma layout (rows padded to 136
//     values: ldmatrix conflict-free); int8 and int4 tiles land raw and are
//     converted to bf16 once per block, as dq_gemm.cu does;
//   - 4 warps, each owning 16 keys of every tile and its own online softmax
//     (exp2 domain, fp32) over the block's 16 (padded) rows: S = Q K^T by
//     mma.sync m16n8k16 (Q's fragments held in registers for the whole
//     call), then P (probability times v scale, rounded to bf16, as the
//     Pallas kernel rounds it) times V by mma.sync from the same registers:
//     no barrier between the two, one per tile (two with a conversion). One
//     path for every R: the padded rows cost tensor-core work only. The
//     warps' states merge at the end;
//   - the splits merge in the same launch: each writes an fp32 partial (the
//     block's unnormalised rows x D accumulator, running max, denominator)
//     to scratch, and the last block of a (kv head, item, chunk) to take its
//     ticket weighs them (per row, 2^(m_z - M) / L, computed once) and sums
//     them in split order into o, then resets the ticket: no float atomics,
//     bitwise-equal output from call to call, capturable in a CUDA graph. A
//     split with no visible key weighs 2^(-1e29 - M) = 0. With one split the
//     block writes o itself, straight into its (B, K, H, D) place.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py --fold-only,
// device ms from CUDA-graph replays, B=4 items, K=4, Sp=623, Sg=128,
// H=KVH=32; the first design in brackets): per-beam bf16 0.0476-0.0478
// (0.0967; K4's beam mode 0.0631-0.0648, SDPA ~0.08, byte bound 0.0169),
// int8 0.0515-0.0525 (0.1284), int4 0.0475-0.0476 (0.1683); shared stage
// bf16 0.0325 (0.0761), int8 0.0327-0.0330, int4 0.0309-0.0316; batch 80,
// per-beam int4 0.4113-0.4118 (K4's beam mode 0.6708-0.6816). What holds it
// back: a block's per-tile work (two mma chains, the masks, the softmax, an
// int tile's conversion pass and second barrier) rather than bytes in
// flight: one split of 18 tiles a block beats seven splits at B=4 in bf16,
// and taking the integer divisions out of the copy and conversion loops
// took 6-17 % off every int8 and int4 time.

#include "decode_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace halva_decode;
using halva::ldmatrix_x4;
using halva::ldmatrix_x4_trans;
using halva::mma_16816;
using halva::pack_bf16;

constexpr int D = 128;
constexpr int TILE = 64;             // keys per tile
constexpr int ROWS = 16;             // query rows per block (the mma's M)
constexpr int FT = 128;              // threads per block
constexpr int WARPS = FT / 32;
constexpr int WKEYS = TILE / WARPS;  // keys of a tile per warp
constexpr int KS = D + 8;            // bf16 values per staged row
constexpr int TILE_B = TILE * KS * 2;  // a staged bf16 K or V tile, bytes
constexpr int RAW_HALF = TILE * D;     // a raw int8 K or V tile, bytes
constexpr float NEG_BIG = -1e30f;      // logit of a key a row does not see
constexpr int METAS = 4;   // metadata slots: tiles i .. i + 2, and i - 1's
constexpr int MAX_SPLITS = 1024;  // the last block's weights fit the ring
static_assert(WKEYS == 16, "a warp's keys are one k-step of the PV product");

// bf16 caches (DIRECT) stage every tile in the mma layout; the quantized
// modes stage raw tiles and convert each into one bf16 tile
template <bool DIRECT>
__host__ __device__ constexpr int half_slot() {
  return DIRECT ? TILE_B : RAW_HALF;
}

struct Meta {       // one tile's per-token metadata; a masked key: ok 0
  float ksc[TILE];  // k scale (1 for bf16 keys)
  float vsc[TILE];  // v scale
  uint8_t ok[TILE];
};

struct Shared {  // behind the ring (and the converted tile)
  Meta meta[METAS];
  float m[WARPS][ROWS], l[WARPS][ROWS];  // each warp's final state
  float wt[WARPS][ROWS];  // each warp's weight in the block's merge
  float bm[ROWS], bl[ROWS];  // the block's max and denominator per row
  int last;
};

// STAGES ring slots: STAGES - 1 tiles in flight while one is read
template <bool DIRECT, int STAGES>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * 2 * half_slot<DIRECT>() + (DIRECT ? 0 : 2 * TILE_B) +
         (int)sizeof(Shared);
}

// One span of keys of one (item, kv head): the prompt cache, a gen cache row,
// or the fresh candidates; with neither seg nor valid every key is live.
struct Span {
  const char* k;
  const char* v;
  const uint16_t* ks;  // int8: token scales; int4: even-token plane
  const uint16_t* vs;
  long odd;            // int4: offset of the odd-token scale plane
  long stride;         // bytes between cache rows
  const int* seg;
  const uint8_t* valid;
  int S;               // tokens
  int fmt;
  int lo, hi;          // the item's query rows [lo, hi) see this span
  int causal;          // row r sees token t only if t <= r / G
};

struct MetaRegs {
  int live;
  uint16_t ks, vs;
};

// thread base + j, j < TILE: token t0 + j's metadata, fetched ahead
__device__ __forceinline__ MetaRegs meta_fetch(const Span& s, int t0,
                                               int base) {
  MetaRegs r{0, BF16_ONE, BF16_ONE};
  const int j = (int)threadIdx.x - base, t = t0 + j;
  if (j >= 0 && j < TILE && t < s.S) {
    r.live = s.seg ? s.seg[t] != 0 : (s.valid ? s.valid[t] != 0 : 1);
    if (s.fmt != BF16) {
      const long i = s.fmt == I4 ? (t & 1) * s.odd + (t >> 1) : t;
      r.ks = s.ks[i];
      r.vs = s.vs[i];
    }
  }
  return r;
}

__device__ __forceinline__ void meta_store(Meta& m, const MetaRegs& r,
                                           int base) {
  const int i = (int)threadIdx.x - base;
  if (i >= 0 && i < TILE) {
    m.ok[i] = r.live != 0;
    m.ksc[i] = r.live ? bf16_bits(r.ks) : 0.f;
    m.vsc[i] = r.live ? bf16_bits(r.vs) : 0.f;
  }
}

// keys of the tile a warp may read: up to the 16-key quarter that holds the
// span's last token (a later quarter has no live key and is skipped)
__device__ __forceinline__ int tile_keys(const Span& s, int t0) {
  return min(TILE, (s.S - t0 + WKEYS - 1) / WKEYS * WKEYS);
}

// the tile's K rows, then its V rows `half` bytes behind, into a ring slot
template <bool DIRECT>
__device__ __forceinline__ void kv_issue(const Span& s, int t0, const Meta& m,
                                         char* dst) {
  constexpr int HALF = half_slot<DIRECT>();
  const int lg = s.fmt == BF16 ? 4 : 3;  // log2 of 16-byte chunks a row
  const int rb = 16 << lg;               // bytes per cache row
  const int rows = s.fmt == I4 ? tile_keys(s, t0) / 2 : tile_keys(s, t0);
  const int ds = DIRECT ? KS * 2 : rb;
  const long r0 = s.fmt == I4 ? t0 / 2 : t0;
  for (int c = threadIdx.x; c < rows << lg; c += FT) {
    const int r = c >> lg, cc = c & ((1 << lg) - 1);
    const bool live =
        s.fmt == I4 ? (m.ok[2 * r] | m.ok[2 * r + 1]) != 0 : m.ok[r] != 0;
    const long off = live ? (r0 + r) * s.stride + cc * 16 : 0;
    cp_async16(dst + r * ds + cc * 16, s.k + off, live);
    cp_async16(dst + HALF + r * ds + cc * 16, s.v + off, live);
  }
}

__device__ __forceinline__ uint4 bytes_to_bf16(uint32_t w0, uint32_t w1) {
  return make_uint4(pack_bf16(sbyte(w0, 0), sbyte(w0, 1)),
                    pack_bf16(sbyte(w0, 2), sbyte(w0, 3)),
                    pack_bf16(sbyte(w1, 0), sbyte(w1, 1)),
                    pack_bf16(sbyte(w1, 2), sbyte(w1, 3)));
}

__device__ __forceinline__ uint4 nibs_to_bf16(uint32_t w0, uint32_t w1,
                                              int sh) {
  return make_uint4(pack_bf16(nib(w0, 0, sh), nib(w0, 1, sh)),
                    pack_bf16(nib(w0, 2, sh), nib(w0, 3, sh)),
                    pack_bf16(nib(w1, 0, sh), nib(w1, 1, sh)),
                    pack_bf16(nib(w1, 2, sh), nib(w1, 3, sh)));
}

// a raw tile (K, then V RAW_HALF bytes behind) -> bf16 K and V tiles in the
// mma layout; 16 raw bytes per thread and pass
__device__ __forceinline__ void convert(const char* src, const Span& s, int t0,
                                        __nv_bfloat16* cvt) {
  const int keys = tile_keys(s, t0);
  if (s.fmt == BF16) {  // candidates: copied, 16 chunks a row
    for (int c = threadIdx.x; c < 2 * keys * 16; c += FT) {
      const int kv = c >= keys * 16, e = c - kv * keys * 16;
      const int r = e >> 4, cc = e & 15;
      *reinterpret_cast<uint4*>(cvt + kv * TILE * KS + r * KS + cc * 8) =
          *reinterpret_cast<const uint4*>(src + kv * RAW_HALF + r * 2 * D +
                                          cc * 16);
    }
    return;
  }
  const int rows = s.fmt == I4 ? keys / 2 : keys;  // raw rows of D bytes
  for (int c = threadIdx.x; c < 2 * rows * 8; c += FT) {
    const int kv = c >= rows * 8, e = c - kv * rows * 8;
    const int r = e >> 3, cc = e & 7;
    const uint4 x = *reinterpret_cast<const uint4*>(src + kv * RAW_HALF +
                                                    r * D + cc * 16);
    __nv_bfloat16* d = cvt + kv * TILE * KS + cc * 16;
    if (s.fmt == I8) {
      *reinterpret_cast<uint4*>(d + r * KS) = bytes_to_bf16(x.x, x.y);
      *reinterpret_cast<uint4*>(d + r * KS + 8) = bytes_to_bf16(x.z, x.w);
    } else {  // byte row r: token 2r in the low nibbles, 2r + 1 in the high
      *reinterpret_cast<uint4*>(d + 2 * r * KS) = nibs_to_bf16(x.x, x.y, 0);
      *reinterpret_cast<uint4*>(d + 2 * r * KS + 8) =
          nibs_to_bf16(x.z, x.w, 0);
      *reinterpret_cast<uint4*>(d + (2 * r + 1) * KS) =
          nibs_to_bf16(x.x, x.y, 4);
      *reinterpret_cast<uint4*>(d + (2 * r + 1) * KS + 8) =
          nibs_to_bf16(x.z, x.w, 4);
    }
  }
}

struct FoldArgs {
  const __nv_bfloat16* q;
  const void *kp, *vp;
  const uint16_t *kps, *vps;
  const int* seg;
  const void *kg, *vg;
  const uint16_t *kgs, *vgs;
  const uint8_t* gv;
  const __nv_bfloat16 *kc, *vc;
  __nv_bfloat16* o;
  float* part;
  int* tickets;
  int K, G, H, KVH, Sp, sp_rows, Sg, shared_gen, psplits, tps, gsplits;
  float sl2;
};

// one split's partial in scratch: accumulator (ROWS x D), max, denominator
constexpr int PART = ROWS * (D + 2);

// PF / GF: prompt and gen cache formats. Block (n, b * chunks + c, z): kv
// head n, item b, rows [16 c, 16 c + 16) of the item's K*G, split z. Split z
// < psplits takes prompt tiles [z * tps, min((z + 1) * tps, ceil(Sp / 64)));
// with gsplits = 0 the last split also takes the chunk's gen spans (and the
// candidates), else split psplits + i takes gen span i of the chunk.
template <int PF, int GF, int STAGES>
__global__ void __launch_bounds__(FT, STAGES == 2 ? 3 : 2)
    fold_attn_kernel(const FoldArgs a) {
  constexpr bool DIRECT = PF == BF16 && GF == BF16;
  constexpr int HALF = half_slot<DIRECT>();
  constexpr int SLOT = 2 * HALF;
  constexpr int RING = STAGES * SLOT + (DIRECT ? 0 : 2 * TILE_B);
  static_assert(WARPS * ROWS * D * 4 <= RING && MAX_SPLITS * ROWS * 4 <= RING,
                "the final sums reuse the ring (and the converted tile)");
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* cvt = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * SLOT);
  Shared& sh = *reinterpret_cast<Shared*>(smem + STAGES * SLOT +
                                          (DIRECT ? 0 : 2 * TILE_B));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = a.K, G = a.G, KVH = a.KVH, R = K * G;
  const int chunks = (R + ROWS - 1) / ROWS;
  const int n = blockIdx.x, b = blockIdx.y / chunks, c = blockIdx.y % chunks;
  const int z = blockIdx.z, splits = a.psplits + a.gsplits;
  const int row0 = c * ROWS, live = min(ROWS, R - row0);
  const int cb = R <= ROWS ? K : ROWS / G;  // beams of a chunk
  const int jc0 = c * cb, jc1 = min(K, jc0 + cb);

  // this thread's 16-byte pieces of the block's query rows, loaded now and
  // staged after the first metadata loads are in flight (rows past the
  // item's: zeros)
  uint4 qx[ROWS * (D / 8) / FT];
#pragma unroll
  for (int j = 0; j < ROWS * (D / 8) / FT; ++j) {
    const int e = tid + j * FT, i = e / (D / 8), cc = e % (D / 8);
    qx[j] = make_uint4(0, 0, 0, 0);
    if (i < live) {
      const int r = row0 + i;
      qx[j] = *reinterpret_cast<const uint4*>(
          a.q + (((long)b * K + r / G) * a.H + n * G + r % G) * D + cc * 8);
    }
  }

  const long phead = (long)b * KVH + n;
  Span ps;
  ps.k = static_cast<const char*>(a.kp) + phead * a.sp_rows * row_bytes<PF>(D);
  ps.v = static_cast<const char*>(a.vp) + phead * a.sp_rows * row_bytes<PF>(D);
  if (PF == I4) {  // (B, 2, KVH, sp_rows): even plane, odd plane behind it
    ps.ks = a.kps + ((long)b * 2 * KVH + n) * a.sp_rows;
    ps.vs = a.vps + ((long)b * 2 * KVH + n) * a.sp_rows;
    ps.odd = (long)KVH * a.sp_rows;
  } else {
    ps.ks = a.kps ? a.kps + phead * a.Sp : nullptr;
    ps.vs = a.vps ? a.vps + phead * a.Sp : nullptr;
    ps.odd = 0;
  }
  ps.stride = row_bytes<PF>(D);
  ps.seg = a.seg + (long)b * a.Sp;
  ps.valid = nullptr;
  ps.S = a.Sp;
  ps.fmt = PF;
  ps.lo = 0;
  ps.hi = R;
  ps.causal = 0;
  auto gen_span = [&](int j) {  // beam j's gen row, or the item's shared one
    const long grow = a.shared_gen ? (long)b : (long)b * K + j;
    const long ghead = grow * KVH + n;
    Span s;
    s.k = static_cast<const char*>(a.kg) + ghead * a.Sg * row_bytes<GF>(D);
    s.v = static_cast<const char*>(a.vg) + ghead * a.Sg * row_bytes<GF>(D);
    s.ks = a.kgs ? a.kgs + ghead * a.Sg : nullptr;
    s.vs = a.vgs ? a.vgs + ghead * a.Sg : nullptr;
    s.odd = 0;
    s.stride = row_bytes<GF>(D);
    s.seg = nullptr;
    s.valid = a.gv + grow * a.Sg;
    s.S = a.Sg;
    s.fmt = GF;
    s.lo = a.shared_gen ? 0 : j * G;
    s.hi = a.shared_gen ? R : (j + 1) * G;
    s.causal = 0;
    return s;
  };
  Span cs;  // the fresh candidates (B, K, KVH, D): token j is candidate j
  cs.k = reinterpret_cast<const char*>(a.kc + ((long)b * K * KVH + n) * D);
  cs.v = reinterpret_cast<const char*>(a.vc + ((long)b * K * KVH + n) * D);
  cs.ks = cs.vs = nullptr;
  cs.odd = 0;
  cs.stride = (long)KVH * D * 2;
  cs.seg = nullptr;
  cs.valid = nullptr;
  cs.S = K;
  cs.fmt = BF16;
  cs.lo = 0;
  cs.hi = R;
  cs.causal = 1;

  // this block's tiles: np_ prompt tiles from p0, the gen spans of beams
  // [jlo, jhi) (shared stage: the one shared span), then the candidates
  const int ptiles = (a.Sp + TILE - 1) / TILE;
  const int gtiles = (a.Sg + TILE - 1) / TILE;
  int p0 = 0, np_ = 0, jlo = 0, jhi = 0, ncand = 0;
  if (z < a.psplits) {
    p0 = min(z * a.tps, ptiles);
    np_ = min(p0 + a.tps, ptiles) - p0;
  }
  if (a.gsplits == 0 ? z == splits - 1 : z >= a.psplits) {
    if (a.shared_gen) {
      jhi = 1;
      ncand = a.kc != nullptr;
    } else if (a.gsplits == 0) {
      jlo = jc0;
      jhi = jc1;
    } else {
      jlo = jc0 + z - a.psplits;
      jhi = max(jlo, min(jlo + 1, jc1));
    }
  }
  const int ngen = (jhi - jlo) * gtiles;
  const int nt = np_ + ngen + ncand;
  auto tile = [&](int i, int& t0) {
    if (i < np_) {
      t0 = (p0 + i) * TILE;
      return ps;
    }
    i -= np_;
    if (i < ngen) {
      t0 = (i % gtiles) * TILE;
      return gen_span(jlo + i / gtiles);
    }
    t0 = 0;
    return cs;
  };
  auto fetch = [&](int i, int base) {
    if (i >= nt) return MetaRegs{0, BF16_ONE, BF16_ONE};
    int t0;
    const Span s = tile(i, t0);
    return meta_fetch(s, t0, base);
  };
  auto issue = [&](int i) {
    int t0;
    const Span s = tile(i, t0);
    kv_issue<DIRECT>(s, t0, sh.meta[i % METAS], smem + (i % STAGES) * SLOT);
  };

  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  // the beams of this lane's rows g and g + 8 (the candidates they see)
  const int beam_of[2] = {(row0 + g) / G, (row0 + g + 8) / G};
  float mrun[2] = {M_INIT, M_INIT}, lrun[2] = {0.f, 0.f};  // rows g, g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // prologue: tiles 0 and 1's metadata in one round trip (threads 0-63 and
  // 64-127), the query rows into the last slot (first written by tile
  // STAGES - 1's copies, after the loop's first barrier), then the first
  // AHEAD tiles' rows in flight and tile 2's metadata on its way
  MetaRegs r = fetch(tid / TILE, tid / TILE * TILE);
  {
    __nv_bfloat16* qs =
        reinterpret_cast<__nv_bfloat16*>(smem + (STAGES - 1) * SLOT);
#pragma unroll
    for (int j = 0; j < ROWS * (D / 8) / FT; ++j) {
      const int e = tid + j * FT;
      *reinterpret_cast<uint4*>(qs + e / (D / 8) * KS + e % (D / 8) * 8) =
          qx[j];
    }
  }
  meta_store(sh.meta[tid / TILE], r, tid / TILE * TILE);
  r = fetch(2, 0);
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qr =
        reinterpret_cast<const __nv_bfloat16*>(smem + (STAGES - 1) * SLOT) +
        ((lane & 7) + (lane & 8)) * KS + ((lane & 16) >> 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], qr + kk * 16);
  }
  constexpr int AHEAD = STAGES - 1;  // tiles in flight while one is read
  static_assert(AHEAD == 1 || AHEAD == 2, "metadata travels two tiles ahead");
  for (int i = 0; i < AHEAD; ++i) {
    if (i < nt) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    // tile i + 2's metadata (its slot last read by tile i - 2), tile i + 3's
    // fetched, tile i's rows landed (the next AHEAD - 1 may be in flight);
    // then tile i + AHEAD's rows go in flight into the slot tile i - 1 left
    meta_store(sh.meta[(i + 2) % METAS], r, 0);
    r = fetch(i + 3, 0);
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    if (i + AHEAD < nt) issue(i + AHEAD);
    cp_async_commit();
    {
      int t0;
      const Span s = tile(i, t0);
      const Meta& m = sh.meta[i % METAS];
      const char* slot = smem + (i % STAGES) * SLOT;
      const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(slot);
      if constexpr (!DIRECT) {
        convert(slot, s, t0, cvt);
        __syncthreads();
        kt = cvt;
      }
      const __nv_bfloat16* vt = DIRECT ? kt + HALF / 2 : kt + TILE * KS;
      const int key0 = warp * WKEYS;
      if (__any_sync(0xffffffffu, m.ok[key0 + (lane & 15)])) {
        // S = Q K^T on this warp's 16 keys: two 8-key n-tiles, each summed
        // in two chains (even and odd k-steps) that run side by side
        float sc[2][4], sd[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[0][e] = sc[1][e] = sd[0][e] = sd[1][e] = 0.f;
        const __nv_bfloat16* kr =
            kt + (key0 + (lane & 7) + (lane & 8)) * KS + ((lane & 16) >> 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kr + kk * 16);
          if (kk & 1) {
            mma_16816(sd[0], qa[kk], bk[0], bk[2]);
            mma_16816(sd[1], qa[kk], bk[1], bk[3]);
          } else {
            mma_16816(sc[0], qa[kk], bk[0], bk[2]);
            mma_16816(sc[1], qa[kk], bk[1], bk[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[0][e] += sd[0][e];
          sc[1][e] += sd[1][e];
        }
        // logits in the exp2 domain times the k scale; not visible: NEG_BIG.
        // Row h sees this span's keys up to tile index last[h] (-1: none)
        int last[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + g + 8 * h;
          last[h] = row < s.lo || row >= s.hi
                        ? -1
                        : (s.causal ? beam_of[h] - t0 : TILE);
        }
        float mx[2] = {M_INIT, M_INIT};
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * nt2 + 2 * t4 + (e & 1);
            const bool vis = m.ok[key] && key <= last[e >> 1];
            sc[nt2][e] = vis ? sc[nt2][e] * a.sl2 * m.ksc[key] : NEG_BIG;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt2][e]);
          }
        float al[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float mn = fmaxf(mrun[h], mx[h]);
          al[h] = exp2f(mrun[h] - mn);
          mrun[h] = mn;
          lrun[h] *= al[h];
        }
        float pv[2][4];
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * nt2 + 2 * t4 + (e & 1);
            const float p = exp2f(sc[nt2][e] - mrun[e >> 1]);
            lrun[e >> 1] += p;
            pv[nt2][e] = p * m.vsc[key];  // v scale 1 for a bf16 key
          }
        if (al[0] != 1.f || al[1] != 1.f) {  // a row's max moved
#pragma unroll
          for (int i2 = 0; i2 < D / 8; ++i2) {
            acc[i2][0] *= al[0];
            acc[i2][1] *= al[0];
            acc[i2][2] *= al[1];
            acc[i2][3] *= al[1];
          }
        }
        // acc += P V: P's fragments are S's; V (keys x dims) by ldmatrix.trans
        const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]),
                                pack_bf16(pv[0][2], pv[0][3]),
                                pack_bf16(pv[1][0], pv[1][1]),
                                pack_bf16(pv[1][2], pv[1][3])};
        const __nv_bfloat16* vr =
            vt + (key0 + (lane & 7) + (lane & 8)) * KS + ((lane & 16) >> 1);
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + dt * 8);
          mma_16816(acc[dt], pa, bv[0], bv[1]);
          mma_16816(acc[dt + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring: it holds the sum now

  // the warps' states: accumulators to shared memory, denominators summed
  // over the four lanes of a row
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrun[h] += __shfl_xor_sync(0xffffffffu, lrun[h], 1);
    lrun[h] += __shfl_xor_sync(0xffffffffu, lrun[h], 2);
  }
#pragma unroll
  for (int i2 = 0; i2 < D / 8; ++i2) {
    const int d = i2 * 8 + 2 * t4;
    *reinterpret_cast<float2*>(red + (warp * ROWS + g) * D + d) =
        make_float2(acc[i2][0], acc[i2][1]);
    *reinterpret_cast<float2*>(red + (warp * ROWS + g + 8) * D + d) =
        make_float2(acc[i2][2], acc[i2][3]);
  }
  if (t4 == 0) {
    sh.m[warp][g] = mrun[0];
    sh.m[warp][g + 8] = mrun[1];
    sh.l[warp][g] = lrun[0];
    sh.l[warp][g + 8] = lrun[1];
  }
  __syncthreads();
  // the block's max and denominator per row, and each warp's weight
  if (tid < ROWS) {
    float mx = M_INIT, l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh.m[w][tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sh.wt[w][tid] = exp2f(sh.m[w][tid] - mx);
      l += sh.wt[w][tid] * sh.l[w][tid];
    }
    sh.bm[tid] = mx;
    sh.bl[tid] = l;
  }
  __syncthreads();
  auto block_acc = [&](int i) {  // element i = row * D + d, unnormalised
    const int row = i / D, d = i % D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      v += sh.wt[w][row] * red[(w * ROWS + row) * D + d];
    return v;
  };
  auto out = [&](int i) -> __nv_bfloat16& {  // row i / D of the block in o
    const int rr = row0 + i / D;
    return a.o[(((long)b * K + rr / G) * a.H + n * G + rr % G) * D + i % D];
  };
  if (splits == 1) {
    for (int i = tid; i < live * D; i += FT) {
      const float l = sh.bl[i / D];
      out(i) = __float2bfloat16(l > 0.f ? block_acc(i) / l : 0.f);
    }
    return;
  }
  const long work = ((long)b * chunks + c) * KVH + n;  // its ticket
  float* mine = a.part + (work * splits + z) * PART;
  for (int i = tid; i < live * D; i += FT) mine[i] = block_acc(i);
  if (tid < live) {
    mine[ROWS * D + tid] = sh.bm[tid];
    mine[ROWS * D + ROWS + tid] = sh.bl[tid];
  }
  __threadfence();  // this block's partial reaches L2 before its ticket
  __syncthreads();
  if (tid == 0) sh.last = atomicAdd(&a.tickets[work], 1) == splits - 1;
  __syncthreads();
  if (!sh.last) return;
  // the last block: each split's weight per row (2^(m_z - M) / L, 0 for a
  // row with no visible key) into the ring, then the weighted sums in split
  // order
  const float* all = a.part + work * splits * PART;
  float* wz = reinterpret_cast<float*>(smem);  // [splits][ROWS]
  if (tid < live) {
    float mx = M_INIT, l = 0.f;
    for (int zz = 0; zz < splits; ++zz)
      mx = fmaxf(mx, __ldcg(all + zz * PART + ROWS * D + tid));
    for (int zz = 0; zz < splits; ++zz) {
      wz[zz * ROWS + tid] =
          exp2f(__ldcg(all + zz * PART + ROWS * D + tid) - mx);
      l += wz[zz * ROWS + tid] *
           __ldcg(all + zz * PART + ROWS * D + ROWS + tid);
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int zz = 0; zz < splits; ++zz) wz[zz * ROWS + tid] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < live * D; i += FT) {
    float v = 0.f;
    for (int zz = 0; zz < splits; ++zz)
      v += wz[zz * ROWS + i / D] * __ldcg(all + zz * PART + i);
    out(i) = __float2bfloat16(v);
  }
  if (tid == 0) a.tickets[work] = 0;
}

// above 48 KB of dynamic shared memory needs the opt-in, once per kernel and
// device (the first launch is never inside a CUDA graph capture: the callers
// warm up first)
template <int PF, int GF, int STAGES>
int launch_stages(const FoldArgs& a, int B, cudaStream_t st) {
  static uint64_t smem_set = 0;
  constexpr int bytes = smem_bytes<PF == BF16 && GF == BF16, STAGES>();
  auto kernel = fold_attn_kernel<PF, GF, STAGES>;
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
  const int chunks = (a.K * a.G + ROWS - 1) / ROWS;
  const dim3 grid(a.KVH, B * chunks, a.psplits + a.gsplits);
  kernel<<<grid, FT, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// a split of a few tiles wants them in flight at once (three stages, two
// blocks an SM); a whole item's keys in one block (one split: the work items
// fill the card) want the blocks (two stages, three blocks an SM)
template <int PF, int GF>
int launch(const FoldArgs& a, int B, cudaStream_t st) {
  return a.psplits + a.gsplits == 1 ? launch_stages<PF, GF, 2>(a, B, st)
                                    : launch_stages<PF, GF, 3>(a, B, st);
}

}  // namespace

// fmt: 0 = bf16 prompt and gen caches (kps, vps, kgs, vgs null), 1 = int8
// prompt and gen caches, 2 = int4 prompt cache (sp_rows = ceil(Sp / 2)) and
// int8 gen cache. q, o (B, K, H, D) bf16; kp/vp (B, KVH, sp_rows, D); seg
// (B, Sp) int32; kg/vg (B*K or B, KVH, Sg, D); gvalid (B*K or B, Sg) bool;
// kc/vc (B, K, KVH, D) bf16 or null (then no candidate stage). The plan
// (psplits, tps, gsplits): see fold_attn_kernel; part: fp32 scratch of
// B * chunks * KVH * splits * 16 * (D + 2) (unused with one split), chunks =
// ceil(K * H / KVH / 16); tickets: >= B * chunks * KVH zeroed int32, left
// zeroed. Returns a cudaError_t.
extern "C" int halva_fold_attn(int fmt, const void* q, const void* kp,
                               const void* vp, const void* kps,
                               const void* vps, const void* seg,
                               const void* kg, const void* vg,
                               const void* kgs, const void* vgs,
                               const void* gvalid, const void* kc,
                               const void* vc, void* o, void* part,
                               void* tickets, int B, int K, int H, int KVH,
                               int Sp, int sp_rows, int Sg, int D_,
                               int shared_gen, int psplits, int tps,
                               int gsplits, float scale, void* stream) {
  if (B <= 0 || K < 1 || K > 8 || KVH <= 0 || H % KVH != 0 || Sp < 0 ||
      Sg < 0 || D_ != D || (kc == nullptr) != (vc == nullptr) ||
      (kc != nullptr && !shared_gen) ||
      sp_rows != (fmt == 2 ? (Sp + 1) / 2 : Sp))
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  // the plan: prompt splits of tps tiles, none empty; gen splits: none (the
  // last split takes the gen spans), or one per beam of a chunk (per-beam
  // stage), or one (shared stage)
  const int R = K * G, chunks = (R + ROWS - 1) / ROWS;
  const int ptiles = (Sp + TILE - 1) / TILE;
  const int beams = R <= ROWS ? K : ROWS / G;
  const int splits = psplits + gsplits;
  if (psplits < 0 || tps < 0 || splits < 1 || splits > MAX_SPLITS ||
      (long)B * chunks > 65535 || (gsplits == 0 && psplits < 1) ||
      (gsplits != 0 && gsplits != (shared_gen ? 1 : beams)) ||
      (long)psplits * tps < ptiles ||
      (psplits > 1 && (long)(psplits - 1) * tps >= ptiles) ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FoldArgs a{static_cast<const __nv_bfloat16*>(q),
                   kp,
                   vp,
                   static_cast<const uint16_t*>(kps),
                   static_cast<const uint16_t*>(vps),
                   static_cast<const int*>(seg),
                   kg,
                   vg,
                   static_cast<const uint16_t*>(kgs),
                   static_cast<const uint16_t*>(vgs),
                   static_cast<const uint8_t*>(gvalid),
                   static_cast<const __nv_bfloat16*>(kc),
                   static_cast<const __nv_bfloat16*>(vc),
                   static_cast<__nv_bfloat16*>(o),
                   static_cast<float*>(part),
                   static_cast<int*>(tickets),
                   K,
                   G,
                   H,
                   KVH,
                   Sp,
                   sp_rows,
                   Sg,
                   shared_gen,
                   psplits,
                   tps,
                   gsplits,
                   scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0:
      return launch<BF16, BF16>(a, B, st);
    case 1:
      return launch<I8, I8>(a, B, st);
    case 2:
      return launch<I4, I8>(a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
