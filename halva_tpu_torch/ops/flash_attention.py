"""Flash attention with segment ids: K1 (forward, csrc/flash_fwd.cu), K2 and
K3 (backward, csrc/flash_bwd.cu), and their plain versions.

Counterpart of halva_tpu/ops/flash_attention.py. Public layout (B, S, H, D)
like the rest of the package; GQA when KVH divides H.

`flash_attention` on CUDA tensors is a `torch.autograd.Function`: the
forward launches K1 and keeps o and the log-sum-exp, the backward computes
delta = rowsum(dO * O) and launches K2 (dQ) and K3 (dK, dV). On CPU tensors
it is `flash_attention_plain`, and autograd goes through the plain ops.
There is no fallback: on a CUDA tensor it launches or raises.
`flash_fwd_plan` and `flash_bwd_plan` give the kernels' launch plans;
`flash_attention_tiled_plain` and `flash_attention_bwd_tiled_plain` walk
the tiles in the kernels' order with the tile rule `flash_tile_kind`.

Three modes beside the base one, all computed inside the kernels:
- `alibi`: the MPT bias -slope_h * (row - col) on the scaled logits, with
  slope_h = 2^(-8(h+1)/H) of the query head h (power-of-two head counts
  only; others raise, and ops/attention.py sends them to the plain path).
  The kernels use the signed distance, the plain version |row - col|: the
  two agree only under the causal mask, so `alibi` without `causal` raises
  on both devices.
- `sliding_window`: a pair is live only if row - col < window; key tiles
  (K1, K2) and query tiles (K3) wholly outside the window are skipped.
- `q_offset`: a host int, the position of query row 0 (a shard of the
  queries against all keys, Sq != Skv): row = q_offset + query index in the
  causal, window and ALiBi terms.
Launches count under the kernel's name plus `mode_suffix`: flash_fwd,
flash_fwd_alibi, flash_fwd_window (and flash_fwd_alibi_window), likewise
flash_bwd_dq* and flash_bwd_dkv*; `q_offset` is an argument of each of those
and has no counter of its own.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.attention import (
    alibi_in_kernel,
    alibi_slopes,
    attention_reference,
    causal_alibi_bias,
    make_attention_mask,
)
from halva_tpu_torch.ops.decode_attention import sm_count

KERNEL = "flash_fwd"
KERNEL_DQ = "flash_bwd_dq"
KERNEL_DKV = "flash_bwd_dkv"

# K1's geometry (csrc/flash_fwd.cu): a block owns FWD_BQ query rows of one
# (batch row, head), FWD_WG_ROWS per consumer warpgroup, and walks the keys
# in tiles of bk through a ring of FWD_STAGES[bk] stages
FWD_BQ = 128
FWD_WG_ROWS = 64
FWD_STAGES = {64: 4, 128: 2}
# the key tile: 64 up to FWD_LONG_KEYS keys, 128 above (measured on an H100,
# PERF.md section 6: 64 wins at the prefill and train rows, 128 on a
# 4,608-token row)
FWD_LONG_KEYS = 2048
# the logit of a masked pair and the running max's start, in the exp2
# domain: exp2(NEG_BIG - M_INIT) is 0, and a row with no live key keeps
# M_INIT, so its LSE is M_INIT * ln 2
NEG_BIG = -1e30
M_INIT = -1e29
LOG2E = 1.4426950408889634


# K2's and K3's geometry (csrc/flash_bwd.cu): a K2 block owns BWD_DQ_ROWS
# query rows of one (batch row, head) and walks the keys in tiles of
# BWD_TILE; a K3 block owns 128 keys (64 a consumer warpgroup) or 64 keys
# (both warpgroups, alternate query tiles) of one (batch row, kv head) and
# walks the query tiles of BWD_TILE rows; both rings have BWD_STAGES stages
BWD_DQ_ROWS = 128
BWD_TILE = 64
BWD_STAGES = 4
BWD_DKV_KEYS = (128, 64)
# K3 takes 64-key blocks where 128-key ones would give fewer than this many
# blocks an SM (measured on an H100, PERF.md section 6: 64 wins at Mistral's
# B=2 train shape, 1.1 blocks an SM at 128, and loses at 2.2 and more)
BWD_DKV_MIN_BLOCKS_PER_SM = 2
H100_SMS = 132


class FwdPlan(NamedTuple):
    bq: int  # query rows per block
    bk: int  # keys per tile
    stages: int  # tiles in flight in the ring
    blocks: int  # thread blocks of the launch (one per SM at a time)


def flash_fwd_plan(b: int, sq: int, skv: int, h: int,
                   bk: Optional[int] = None) -> FwdPlan:
    """K1's launch plan for B rows of Sq queries against Skv keys and H
    query heads; `bk` forces the key tile."""
    if bk is None:
        bk = 128 if skv > FWD_LONG_KEYS else 64
    if bk not in FWD_STAGES:
        raise ValueError(f"flash_fwd: key tile {bk} is not one of "
                         f"{sorted(FWD_STAGES)}")
    return FwdPlan(FWD_BQ, bk, FWD_STAGES[bk], b * h * -(-sq // FWD_BQ))


class BwdKernelPlan(NamedTuple):
    rows: int  # K2: query rows per block; K3: keys per block
    tile: int  # K2: keys per tile; K3: queries per tile
    stages: int  # tiles in flight in the ring
    blocks: int  # thread blocks of the launch (one per SM at a time)
    order: str  # which blocks the grid issues first


class BwdPlan(NamedTuple):
    dq: BwdKernelPlan  # K2
    dkv: BwdKernelPlan  # K3


def flash_bwd_plan(b: int, sq: int, skv: int, h: int, kvh: int,
                   dkv_keys: Optional[int] = None,
                   sms: int = H100_SMS) -> BwdPlan:
    """K2's and K3's launch plans for B rows of Sq queries (H heads) against
    Skv keys (KVH heads) on a card of `sms` SMs; `dkv_keys` forces K3's
    keys a block (128 or 64)."""
    dq = BwdKernelPlan(BWD_DQ_ROWS, BWD_TILE, BWD_STAGES,
                       b * h * -(-sq // BWD_DQ_ROWS), "last query tile first")
    if dkv_keys is None:
        wide = b * kvh * -(-skv // BWD_DKV_KEYS[0])
        dkv_keys = BWD_DKV_KEYS[
            wide < BWD_DKV_MIN_BLOCKS_PER_SM * sms]
    if dkv_keys not in BWD_DKV_KEYS:
        raise ValueError(f"flash_bwd_dkv: {dkv_keys} keys a block is not "
                         f"one of {sorted(BWD_DKV_KEYS)}")
    dkv = BwdKernelPlan(dkv_keys, BWD_TILE, BWD_STAGES,
                        b * kvh * -(-skv // dkv_keys), "first key tile first")
    return BwdPlan(dq, dkv)


def flash_tile_kind(c0: int, bk: int, skv: int, kmin: int, kmax: int,
                    qmin: int, qmax: int, p_lo: int, p_hi: int, causal: bool,
                    window: int) -> str:
    """K1's rule for key tile [c0, c0 + bk) and query rows at positions
    [p_lo, p_hi] (q_offset + row index) whose segment ids span [qmin, qmax]
    (both 0: no live row), the tile's ids below skv spanning [kmin, kmax].

    "skip": no pair can be live (every id 0 on one side, disjoint id ranges,
    the whole tile above the causal diagonal or behind the window); "full":
    every pair is live (one nonzero id on both sides, no ragged end, the
    tile wholly below the diagonal and inside the window); "masked": the
    per-pair mask decides."""
    c_last = min(c0 + bk, skv) - 1
    if ((qmin == 0 and qmax == 0) or (kmin == 0 and kmax == 0)
            or kmax < qmin or kmin > qmax):
        return "skip"
    if causal and c0 > p_hi:
        return "skip"
    if window > 0 and p_lo - c_last >= window:
        return "skip"
    full = (c0 + bk <= skv and qmin == qmax == kmin == kmax
            and (not causal or p_lo >= c_last)
            and (window == 0 or p_hi - c0 < window))
    return "full" if full else "masked"


def flash_attention_tiled_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq)
    kv_segment_ids: torch.Tensor,  # (B, Skv)
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
    bq: int = FWD_WG_ROWS,
    bk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's loop in torch ops: (o (B, Sq, H, D) in q's dtype, lse (B, H, Sq)
    fp32, natural log). Each tile of bq query rows walks its key tiles of bk
    in order, skips those `flash_tile_kind` calls "skip", masks pairs only
    on "masked" tiles, and keeps the online softmax in the exp2 domain (the
    logits scaled by scale * log2 e, the ALiBi term -slope_h (row - col) *
    log2 e); P is rounded to v's dtype for the PV product, as the Pallas
    kernel rounds it (K1 keeps ~16 bits of it, as two bf16 terms). A row
    with no live key gives o = 0 and LSE = M_INIT * ln 2. The model of
    csrc/flash_fwd.cu's consumer warpgroups (bq = 64), held on the CPU
    against the Pallas kernel."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    window = int(sliding_window or 0)
    off = int(q_offset or 0)
    dev = q.device
    kr = k.repeat_interleave(h // kvh, dim=2).float()
    vr = v.repeat_interleave(h // kvh, dim=2)
    slope2 = (alibi_slopes(h, dev) * LOG2E if alibi
              else torch.zeros(h, device=dev))
    o = torch.zeros(b, sq, h, d, dtype=torch.float32, device=dev)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    for bi in range(b):
        qs = q_segment_ids[bi].tolist()
        ks = kv_segment_ids[bi].tolist()
        for r0 in range(0, sq, bq):
            r1 = min(r0 + bq, sq)
            rows = torch.arange(r0, r1, device=dev)
            p_lo, p_hi = off + r0, off + r1 - 1
            qmin, qmax = min(qs[r0:r1]), max(qs[r0:r1])
            qt = q[bi, r0:r1].float().transpose(0, 1)  # (H, n, D)
            m = torch.full((h, r1 - r0), M_INIT, device=dev)
            l = torch.zeros(h, r1 - r0, device=dev)
            acc = torch.zeros(h, r1 - r0, d, device=dev)
            for c0 in range(0, skv, bk):
                c1 = min(c0 + bk, skv)
                kind = flash_tile_kind(c0, bk, skv, min(ks[c0:c1]),
                                       max(ks[c0:c1]), qmin, qmax, p_lo,
                                       p_hi, causal, window)
                if kind == "skip":
                    continue
                cols = torch.arange(c0, c1, device=dev)
                s = qt @ kr[bi, c0:c1].transpose(0, 1).transpose(1, 2)
                s = s * (scale * LOG2E)
                dist = (off + rows[:, None] - cols[None, :]).float()
                if alibi:
                    s = s - slope2[:, None, None] * dist
                if kind == "masked":
                    qv = q_segment_ids[bi, r0:r1, None]
                    live = (qv == kv_segment_ids[bi, None, c0:c1]) & (qv != 0)
                    if causal:
                        live = live & (dist >= 0)
                    if window:
                        live = live & (dist < window)
                    s = torch.where(live, s, torch.full_like(s, NEG_BIG))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                pv = p.to(v.dtype).float() @ vr[bi, c0:c1].float().transpose(
                    0, 1)
                acc = acc * alpha[..., None] + pv
                m = m_new
            inv = torch.where(l > 0, 1 / torch.where(l > 0, l, 1.0),
                              torch.zeros_like(l))
            o[bi, r0:r1] = (acc * inv[..., None]).transpose(0, 1)
            lse[bi, :, r0:r1] = m * math.log(2) + torch.log(
                torch.where(l > 0, l, torch.ones_like(l)))
    return o.to(q.dtype), lse


def _tile_range(ids) -> Tuple[int, int]:
    return int(ids.min()), int(ids.max())


def _bwd_tile(qt, kt, vt, dot, l2, dl, pos, cols, qs, ks, kind, slope2,
              scale, causal, window, p_dtype, ds_dtype):
    """P and dS of one tile as K2 and K3 compute them, for heads n: q, dO
    (n, r, D), k, v (n, c, D) fp32; l2 = LSE * log2 e and delta (n, r);
    positions pos (r,) and key indices cols (c,); ids qs (r,), ks (c,);
    slope2 (n,). Returns (P rounded to p_dtype, dS rounded to ds_dtype),
    both as fp32 (n, r, c)."""
    x = qt @ kt.transpose(1, 2) * (scale * LOG2E) - l2[..., None]
    dist = (pos[:, None] - cols[None, :]).float()
    x = x - slope2[:, None, None] * dist
    p = torch.exp2(x)
    if kind == "masked":
        live = (qs[:, None] == ks[None, :]) & (qs[:, None] != 0)
        if causal:
            live = live & (dist >= 0)
        if window:
            live = live & (dist < window)
        p = torch.where(live, p, torch.zeros((), device=p.device))
    dp = dot @ vt.transpose(1, 2)
    ds = p * (dp - dl[..., None]) * scale
    return p.to(p_dtype).float(), ds.to(ds_dtype).float()


def flash_attention_bwd_tiled_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq)
    kv_segment_ids: torch.Tensor,  # (B, Skv)
    o: torch.Tensor,  # (B, Sq, H, D) the forward's output
    lse: torch.Tensor,  # (B, H, Sq) fp32, natural log
    do: torch.Tensor,  # (B, Sq, H, D)
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
    dkv_keys: int = BWD_DKV_KEYS[0],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes by K2's key walk and K3's
    query walk in torch ops, tile by tile in the kernels' order: the model
    of csrc/flash_bwd.cu, held on the CPU against the Pallas backward.

    K2: each warpgroup's 64 query rows walk the key tiles of BWD_TILE from
    the block's first key tile in the window to its last under the causal
    mask, skip what `flash_tile_kind` calls "skip" and mask pairs only on
    "masked" tiles. K3: each block of `dkv_keys` keys walks the query tiles
    of BWD_TILE rows from the first that can see its keys (shifted by
    q_offset) to the last inside its keys' window, for each query head of
    its group in turn; each warpgroup's 64 keys (128 a block) or every
    other query tile (64 a block, the two sums added at the end) take the
    tile rule with the query tile in the role of K1's rows. P = exp2 of the
    exp2-domain logit (scale * log2 e, the ALiBi term -slope_h (row - col)
    * log2 e) less LSE * log2 e, selected where masked; P is rounded to
    dO's dtype before dV and dS = P (dP - delta) scale to q's dtype before
    dK and dQ, as the kernels round them; sums in fp32."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    if scale is None:
        scale = d**-0.5
    if dkv_keys not in BWD_DKV_KEYS:
        raise ValueError(f"flash_bwd_dkv: {dkv_keys} keys a block is not "
                         f"one of {sorted(BWD_DKV_KEYS)}")
    window = int(sliding_window or 0)
    off = int(q_offset or 0)
    dev = q.device
    tile, wg_rows = BWD_TILE, BWD_DQ_ROWS // 2
    slope2 = (alibi_slopes(h, dev) * LOG2E if alibi
              else torch.zeros(h, device=dev))
    l2 = lse.float() * LOG2E
    delta = flash_attention_delta(o, do)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    kvmap = torch.arange(h, device=dev) // grp
    dq = torch.zeros(b, h, sq, d, device=dev)
    dk = torch.zeros(b, kvh, skv, d, device=dev)
    dv = torch.zeros(b, kvh, skv, d, device=dev)
    args = dict(scale=scale, causal=causal, window=window, p_dtype=do.dtype,
                ds_dtype=q.dtype)
    for bi in range(b):
        qseg, kseg = q_segment_ids[bi], kv_segment_ids[bi]
        # K2: 64 rows of every head at once (the heads' walks are alike)
        for r0 in range(0, sq, wg_rows):
            r1 = min(r0 + wg_rows, sq)
            blk = r0 - r0 % BWD_DQ_ROWS  # the block's first row
            bp_lo = off + blk
            bp_hi = off + min(blk + BWD_DQ_ROWS, sq) - 1
            t_hi = -(-skv // tile)
            if causal:
                t_hi = min(t_hi, bp_hi // tile + 1)
            t_lo = (max(bp_lo - window + 1, 0) // tile) if window else 0
            pos = torch.arange(off + r0, off + r1, device=dev)
            qr = _tile_range(qseg[r0:r1])
            for t in range(t_lo, t_hi):
                c0, c1 = t * tile, min(t * tile + tile, skv)
                kind = flash_tile_kind(c0, tile, skv, *_tile_range(
                    kseg[c0:c1]), *qr, off + r0, off + r1 - 1, causal,
                    window)
                if kind == "skip":
                    continue
                _, ds = _bwd_tile(
                    qf[bi, :, r0:r1], kf[bi, kvmap, c0:c1],
                    vf[bi, kvmap, c0:c1], dof[bi, :, r0:r1],
                    l2[bi, :, r0:r1], delta[bi, :, r0:r1], pos,
                    torch.arange(c0, c1, device=dev), qseg[r0:r1],
                    kseg[c0:c1], kind, slope2, **args)
                dq[bi, :, r0:r1] += ds @ kf[bi, kvmap, c0:c1]
        # K3: every kv head at once, query head kvh * G + gi of each
        split = dkv_keys == 64
        for kv0 in range(0, skv, dkv_keys):
            kv_last = min(kv0 + dkv_keys, skv) - 1
            qt_lo = max(kv0 - off, 0) // tile if causal else 0
            qt_hi = -(-sq // tile)
            if window:
                past = kv_last + window - off
                qt_hi = min(qt_hi, -(-past // tile) if past > 0 else 0)
            walk = [(gi, qt) for gi in range(grp)
                    for qt in range(qt_lo, qt_hi)]
            for c0 in range(kv0, kv_last + 1, wg_rows):
                c1 = min(c0 + wg_rows, skv)
                cols = torch.arange(c0, c1, device=dev)
                kr = _tile_range(kseg[c0:c1])
                sums = [torch.zeros(2, kvh, c1 - c0, d, device=dev)
                        for _ in range(2 if split else 1)]
                for i, (gi, qt) in enumerate(walk):
                    r0, r1 = qt * tile, min(qt * tile + tile, sq)
                    kind = flash_tile_kind(c0, wg_rows, skv, *kr,
                                           *_tile_range(qseg[r0:r1]),
                                           off + r0, off + r1 - 1, causal,
                                           window)
                    if kind == "skip":
                        continue
                    heads = torch.arange(kvh, device=dev) * grp + gi
                    p, ds = _bwd_tile(
                        qf[bi, heads, r0:r1], kf[bi, :, c0:c1],
                        vf[bi, :, c0:c1], dof[bi, heads, r0:r1],
                        l2[bi, heads, r0:r1], delta[bi, heads, r0:r1],
                        torch.arange(off + r0, off + r1, device=dev), cols,
                        qseg[r0:r1], kseg[c0:c1], kind, slope2[heads],
                        **args)
                    acc = sums[i % 2 if split else 0]
                    acc[0] += ds.transpose(1, 2) @ qf[bi, heads, r0:r1]
                    acc[1] += p.transpose(1, 2) @ dof[bi, heads, r0:r1]
                total = sums[0] + sums[1] if split else sums[0]
                dk[bi, :, c0:c1] = total[0]
                dv[bi, :, c0:c1] = total[1]
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def mode_suffix(alibi: bool, sliding_window: Optional[int]) -> str:
    """The launch counter's suffix for a call's modes ('' = base mode)."""
    return ("_alibi" if alibi else "") + ("_window" if sliding_window else "")


def _mask_and_bias(q, k, q_segment_ids, kv_segment_ids, causal, alibi,
                   sliding_window, q_offset):
    mask = make_attention_mask(q_segment_ids, kv_segment_ids, causal,
                               q_offset=q_offset,
                               sliding_window=sliding_window or None)
    bias = None
    if alibi:
        bias = causal_alibi_bias(q.shape[2], q.shape[1], k.shape[1],
                                 q.device, q_offset or 0)
    return mask, bias


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq)
    kv_segment_ids: torch.Tensor,  # (B, Skv)
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    mask, bias = _mask_and_bias(q, k, q_segment_ids, kv_segment_ids, causal,
                                alibi, sliding_window, q_offset)
    return attention_reference(q, k, v, mask=mask, scale=scale, bias=bias)


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, Sq): the backward's per-row
    statistic, a torch reduction as it is XLA's in the reference."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # (B, Sq)
    kv_segment_ids: torch.Tensor,  # (B, Skv)
    o: torch.Tensor,  # (B, Sq, H, D) the forward's output
    lse: torch.Tensor,  # (B, H, Sq) fp32, natural log
    do: torch.Tensor,  # (B, Sq, H, D)
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes: the plain counterpart of the
    reference's `_flash_bwd`, in every mode of the forward (the ALiBi bias
    enters the recomputed logits; no gradient flows to its slopes). P is recomputed from the saved LSE and selected
    to 0 where masked (a fully masked row's LSE would overflow exp);
    delta = rowsum(dO * O) in fp32; P is rounded to dO's dtype before dV and
    dS = P * (dP - delta) * scale to the input dtype before dK and dQ, as the
    Pallas kernels round them; every product accumulates in fp32; dK and dV
    are summed over each KV head's query group."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = d**-0.5
    mask, bias = _mask_and_bias(q, k, q_segment_ids, kv_segment_ids, causal,
                                alibi, sliding_window, q_offset)
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if bias is not None:
        s = s + bias
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=s.device))
    delta = flash_attention_delta(o, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(b, skv, kvh, g, d).sum(3)
    dv = dv.reshape(b, skv, kvh, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_args(name, q, k, v, q_segment_ids, kv_segment_ids):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    tensors = (q, k, v, q_segment_ids, kv_segment_ids)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: q, k, v must be bfloat16")
    if any(t.dtype != torch.int32 for t in tensors[3:]):
        raise TypeError(f"{name}: segment ids must be int32")
    if (
        k.shape != (b, skv, kvh, d)
        or v.shape != k.shape
        or h % kvh
        or q_segment_ids.shape != (b, sq)
        or kv_segment_ids.shape != (b, skv)
    ):
        raise ValueError(
            f"{name}: bad shapes q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} "
            f"segs {tuple(q_segment_ids.shape)} {tuple(kv_segment_ids.shape)}"
        )
    if d != 128:
        raise ValueError(f"{name}: head dim {d} is not 128")
    if any(not t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, k, v)
    ):
        raise ValueError(f"{name}: inputs must be contiguous, "
                         "q, k, v 16-byte aligned")


def _mode_args(name, h, causal, alibi, sliding_window, q_offset):
    """The kernels' three mode arguments (alibi 0|1, window 0 = none, q_off)
    from the wrapper's; raises on what no kernel computes."""
    if alibi and not causal:
        raise ValueError(
            f"{name}: ALiBi needs causal=True (the kernels add the signed "
            "distance, which equals -|row - col| only under the causal mask)")
    if alibi and not alibi_in_kernel(h):
        raise ValueError(
            f"{name}: in-kernel ALiBi needs power-of-two head counts, got "
            f"{h}; use the plain attention (ops/attention.py does)")
    window = int(sliding_window or 0)
    q_off = int(q_offset or 0)
    if window < 0 or q_off < 0:
        raise ValueError(f"{name}: sliding_window {sliding_window} and "
                         f"q_offset {q_offset} must not be negative")
    return int(bool(alibi)), window, q_off


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
    bk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors: returns (o (B, Sq, H, D) bf16, lse
    (B, H, Sq) fp32, natural log, the ALiBi bias included). Fully masked
    rows give o = 0. `bk` (64 or 128 keys a tile) forces the kernel's
    instance; by default `flash_fwd_plan` picks it from Skv."""
    _check_cuda_args("flash_attention_fwd", q, k, v, q_segment_ids,
                     kv_segment_ids)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    modes = _mode_args("flash_attention_fwd", h, causal, alibi,
                       sliding_window, q_offset)
    if scale is None:
        scale = d**-0.5
    plan = flash_fwd_plan(b, sq, skv, h, bk)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, kvh, d, float(scale), int(causal), *modes,
            plan.bk, stream,
        )
    name = KERNEL + mode_suffix(alibi, sliding_window)
    _kernels.check(err, name)
    _kernels.launches[name] += 1
    return o, lse


def _check_bwd_args(name, q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                    delta):
    _check_cuda_args(name, q, k, v, q_segment_ids, kv_segment_ids)
    b, sq, h, _ = q.shape
    if do.shape != q.shape or lse.shape != (b, h, sq) or (
            delta.shape != lse.shape):
        raise ValueError(
            f"{name}: bad shapes do {tuple(do.shape)} lse {tuple(lse.shape)} "
            f"delta {tuple(delta.shape)} for q {tuple(q.shape)}")
    if do.dtype != torch.bfloat16 or lse.dtype != torch.float32 or (
            delta.dtype != torch.float32):
        raise TypeError(f"{name}: do must be bfloat16, lse and delta fp32")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if any(not t.is_contiguous() for t in (do, lse, delta)) or (
            do.data_ptr() % 16):
        raise ValueError(f"{name}: do, lse, delta must be contiguous, do "
                         "16-byte aligned")


def _bwd_args(name, q, k, v, q_segment_ids, kv_segment_ids, do, lse, delta,
              causal, scale, alibi, sliding_window, q_offset, dkv_keys=None):
    """The kernels' pointers, their shape and mode arguments, and the
    launch plan on q's card."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    modes = _mode_args(name, h, causal, alibi, sliding_window, q_offset)
    plan = flash_bwd_plan(b, sq, skv, h, kvh, dkv_keys, sm_count(q.device))
    return ptrs, (b, sq, skv, h, kvh, d, float(scale), int(causal),
                  *modes), plan


def flash_attention_bwd_dq(q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                           delta, causal: bool = True,
                           scale: Optional[float] = None,
                           alibi: bool = False,
                           sliding_window: Optional[int] = None,
                           q_offset: Optional[int] = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors: dq (B, Sq, H, D) bf16, by the plan of
    `flash_bwd_plan`."""
    name = "flash_attention_bwd_dq"
    _check_bwd_args(name, q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                    delta)
    ptrs, dims, plan = _bwd_args(name, q, k, v, q_segment_ids,
                                 kv_segment_ids, do, lse, delta, causal,
                                 scale, alibi, sliding_window, q_offset)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_flash_bwd_dq_bf16(
            *ptrs, dq.data_ptr(), *dims, plan.dq.tile, stream)
    counter = KERNEL_DQ + mode_suffix(alibi, sliding_window)
    _kernels.check(err, counter)
    _kernels.launches[counter] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                            delta, causal: bool = True,
                            scale: Optional[float] = None,
                            alibi: bool = False,
                            sliding_window: Optional[int] = None,
                            q_offset: Optional[int] = None,
                            dkv_keys: Optional[int] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on CUDA tensors: (dk, dv) (B, Skv, KVH, D) bf16, summed
    over each KV head's query group inside the kernel, by the plan of
    `flash_bwd_plan`; `dkv_keys` (128 or 64 keys a block) forces its
    layout."""
    name = "flash_attention_bwd_dkv"
    _check_bwd_args(name, q, k, v, q_segment_ids, kv_segment_ids, do, lse,
                    delta)
    ptrs, dims, plan = _bwd_args(name, q, k, v, q_segment_ids,
                                 kv_segment_ids, do, lse, delta, causal,
                                 scale, alibi, sliding_window, q_offset,
                                 dkv_keys)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_flash_bwd_dkv_bf16(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, plan.dkv.rows,
            stream)
    counter = KERNEL_DKV + mode_suffix(alibi, sliding_window)
    _kernels.check(err, counter)
    _kernels.launches[counter] += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) bf16 from K2 and K3, in the inputs' layouts; o and lse
    are K1's outputs for the same inputs and modes."""
    if o.shape != q.shape or o.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} on "
                         f"{o.device} for q {tuple(q.shape)} on {q.device}")
    do = do.contiguous()
    delta = flash_attention_delta(o, do)
    args = (q, k, v, q_segment_ids, kv_segment_ids, do, lse.contiguous(),
            delta, causal, scale, alibi, sliding_window, q_offset)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (no gradient into the segment ids)."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, scale,
                alibi, sliding_window, q_offset):
        ctx.modes = (causal, scale, alibi, sliding_window, q_offset)
        o, lse = flash_attention_fwd(q, k, v, q_segment_ids, kv_segment_ids,
                                     *ctx.modes)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_seg, kv_seg, o, lse, do,
                                         *ctx.modes)
        return (dq, dk, dv) + (None,) * 7


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    alibi: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Segment-id flash attention; layout as halva_tpu's flash_attention.
    Differentiable in q, k and v on both devices. `q_offset` is a host int
    (the reference takes a traced scalar), which keeps the launch
    capturable in a CUDA graph."""
    if q_offset is not None and not isinstance(q_offset, int):
        raise TypeError("flash_attention: q_offset must be a host int, got "
                        f"{type(q_offset).__name__}")
    # the same refusals on both devices (the kernel wrappers repeat them)
    _mode_args("flash_attention", q.shape[2], causal, alibi, sliding_window,
               q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_segment_ids, kv_segment_ids, causal, scale, alibi,
            sliding_window, q_offset,
        )
    return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                 causal, scale, alibi, sliding_window,
                                 q_offset)
