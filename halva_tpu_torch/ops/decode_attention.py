"""K4 and K5: fused decode attention (CUDA, csrc/decode_attn.cu and
csrc/fold_attn.cu) and their plain versions.

Counterpart of halva_tpu/ops/decode_attention.py. One query per row attends
the layer's prompt cache (keys with segment id != 0) and its generated-token
cache (slots with gen_valid) in one softmax. Caches are head-major
(B, KVH, S, D): the caller passes the layer slice `cache[li]`, which in torch
is a view, so the reference's "whole stacked cache plus scalar-prefetch layer
index" needs no counterpart here.

Cache formats, by their keys (the reference's):
- bf16 prompt `{k, v}` and gen `{k, v}`;
- int8 prompt `{k, v, k_scale, v_scale}`, scales (B, KVH, Sp), and int8 gen
  `{k, v, k_scale, v_scale}`, scales (B, KVH, Sg);
- int4 prompt `{k4, v4, k_scale, v_scale}`: token pairs nibble-packed along
  the sequence (B, KVH, ceil(Sp/2), D), scales (B, 2, KVH, ceil(Sp/2)) with
  the even/odd plane ahead of the heads, and an int8 gen cache.
The true prompt length is `prompt_seg.shape[1]`.

`decode_attend_layer` launches the kernel for CUDA tensors (one launch
counter per mode: decode_attn, decode_attn_kv8, decode_attn_kv4) and uses
`decode_attend_plain` for CPU tensors; on a CUDA tensor it launches or
raises. Rows with no visible key: the kernel gives 0 (as the Pallas kernel),
the plain version a uniform average (as llama._decode_attend); no caller
reads such rows. K4 splits the key axis across blocks by `decode_plan` and
merges the splits in the same launch; `decode_attend_split_plain` is that
split and merge in plain ops, for the tests and `chip_smoke.py`.

Beams (`beam_k` > 1): q, the gen cache and gen_valid carry B*K rows while
the prompt cache, its scales and segment ids stay at B item rows; row r
reads prompt row r // K. `beam_route="fold"` folds the K beams of an item
into one K5 launch (`fold_attend_layer`, per-beam gen stage), which reads
the item's prompt cache once; `"grid"` takes K4's own beam mode (counters
decode_attn*_beam), which reads it once per beam; `"auto"` (the default)
picks by `auto_beam_route`, from the shapes alone.

K5, `fold_attend_layer`: K queries per item, (B, K, H, Dh), against the
item's prompt cache, then either each beam's own gen cache row (beam
search) or, with `shared_gen`, one gen cache row per item plus K fresh
candidate keys and values attended causally (speculative verify). Counters
fold_attn, fold_attn_kv8, fold_attn_kv4 and the same with `_shared`. Its
plain version, `fold_attend_plain`, gives 0 for a row with no visible key,
as the kernel does. K5 splits the key axis by `fold_plan` and merges the
splits in the same launch; `fold_attend_split_plain` is that split and
merge in plain ops, for the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from halva_tpu_torch import _kernels

KERNEL = "decode_attn"
KERNEL_KV8 = "decode_attn_kv8"
KERNEL_KV4 = "decode_attn_kv4"
BEAM_SUFFIX = "_beam"  # K4's beam mode counts under <mode>_beam
FOLD = {KERNEL: "fold_attn", KERNEL_KV8: "fold_attn_kv8",
        KERNEL_KV4: "fold_attn_kv4"}  # K5's counter of each cache mode
SHARED_SUFFIX = "_shared"  # K5's shared gen stage counts under <mode>_shared
NEG_INF = -1e30
# K4's key-axis split (csrc/decode_attn.cu): keys per tile, and the blocks
# per SM the plan aims at (a bf16 block holds a two-stage ring of 32 KB
# tiles, ~70 KB of shared memory: three fit on an SM)
TILE = 64
BLOCKS_PER_SM = 3
M_INIT = -1e29  # the kernel's running max before any visible key
LOG2E = 1.4426950408889634
# K5's blocks (csrc/fold_attn.cu): query rows per block (the mma's 16), and
# the blocks per SM its plan aims at (a split plan's blocks run a three-stage
# ring, 87-107 KB of shared memory: two fit on an SM)
FOLD_ROWS = 16
FOLD_BLOCKS_PER_SM = 2
BEAM_ROUTES = ("auto", "fold", "grid")
# `auto_beam_route`: K5 above this many bytes of a layer's prompt cache
FOLD_MIN_PROMPT_BYTES = 25_000_000

Cache = Dict[str, torch.Tensor]
Plan = Tuple[int, int]  # (splits, prompt tiles per split)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_plan(rows: int, kvh: int, sp: int, sg: int, sms: int,
                splits: Optional[int] = None) -> Plan:
    """K4's launch plan: (splits, prompt tiles per split), a pure function
    of the shapes and the SM count. The grid is (KVH, rows, splits). Split z
    owns prompt tiles [z * tps, min((z + 1) * tps, ceil(sp / TILE))) (so an
    int4 boundary falls on an even token) and, if it is the last, the whole
    gen span; with more than one split and a gen span, the gen span is a
    split of its own. The count aims at BLOCKS_PER_SM blocks on every SM
    (`splits` forces another aim: the tests' forced plans); 1 where rows *
    kvh blocks alone fill the card. No split is empty: the count may come
    out below the aim."""
    ptiles, gtiles = _cdiv(sp, TILE), _cdiv(sg, TILE)
    want = splits if splits is not None else _cdiv(BLOCKS_PER_SM * sms,
                                                    rows * kvh)
    if want < 1:
        raise ValueError(f"decode_plan: splits={want}")
    if want == 1 or ptiles == 0:
        return 1, ptiles
    psplits = max(1, min(ptiles, want - (1 if gtiles else 0)))
    tps = _cdiv(ptiles, psplits)
    return _cdiv(ptiles, tps) + (1 if gtiles else 0), tps


def split_ranges(plan: Plan, sp: int, sg: int) -> List[List[Tuple[str, int,
                                                                  int]]]:
    """The key ranges of each split of `plan`: [("prompt" | "gen", first
    token, end)], in the kernel's order."""
    splits, tps = plan
    out = []
    for z in range(splits):
        mine = []
        lo, hi = z * tps * TILE, min((z + 1) * tps * TILE, sp)
        if lo < hi:
            mine.append(("prompt", lo, hi))
        if z == splits - 1 and sg:
            mine.append(("gen", 0, sg))
        out.append(mine)
    return out


class FoldPlan(NamedTuple):
    """K5's launch plan (`fold_plan`): the grid is (KVH, items * chunks,
    psplits + gsplits)."""
    chunks: int   # blocks of up to FOLD_ROWS query rows per (item, kv head)
    beams: int    # beams a chunk holds (per-beam stage)
    psplits: int  # prompt splits, tps 64-key tiles each
    tps: int
    gsplits: int  # gen splits: 0 (the last split takes the gen spans), one
    #               per beam of a chunk (per-beam stage) or 1 (shared stage)

    @property
    def splits(self) -> int:
        return self.psplits + self.gsplits


def fold_plan(items: int, kvh: int, rows: int, group: int, sp: int, sg: int,
              sms: int, shared_gen: bool,
              splits: Optional[int] = None) -> FoldPlan:
    """K5's launch plan, a pure function of the shapes and the SM count.
    `rows` = K * G query rows per (item, kv head), `group` = G. A block
    carries up to FOLD_ROWS of them (a chunk: every beam of the item up to
    16 rows, else 16 / G beams). The prompt is cut into `psplits` ranges of
    `tps` 64-key tiles, so an int4 boundary falls on an even token; the gen
    spans take splits of their own: one per beam of the chunk in the
    per-beam stage (only that beam's G rows see it), one for the shared gen
    span and the candidates in the shared stage. The prompt splits aim at
    FOLD_BLOCKS_PER_SM blocks on every SM (`splits` forces another aim);
    where the work items alone fill the card the plan is one split, which
    takes every span. No prompt split is empty."""
    fold_k = rows // group
    chunks = _cdiv(rows, FOLD_ROWS)
    beams = fold_k if rows <= FOLD_ROWS else FOLD_ROWS // group
    ptiles, gtiles = _cdiv(sp, TILE), _cdiv(sg, TILE)
    want = splits if splits is not None else _cdiv(
        FOLD_BLOCKS_PER_SM * sms, items * kvh * chunks)
    if want < 1:
        raise ValueError(f"fold_plan: splits={want}")
    gsplits = 1 if shared_gen else (beams if gtiles else 0)
    if want == 1 or (gsplits == 0 and ptiles <= 1):
        return FoldPlan(chunks, beams, 1, ptiles, 0)
    psplits = min(ptiles, want)
    tps = _cdiv(ptiles, psplits) if psplits else 0
    return FoldPlan(chunks, beams, _cdiv(ptiles, tps) if tps else 0, tps,
                    gsplits)


def fold_split_ranges(plan: FoldPlan, sp: int, sg: int, fold_k: int,
                      shared_gen: bool) -> List[List[List[tuple]]]:
    """The key ranges of every split of every chunk under `plan`, in the
    kernel's order: ("prompt", first token, end), ("gen", beam, 0, sg) (beam
    None: the shared gen row) and ("cand",) (the candidates, shared stage)."""
    out = []
    for c in range(plan.chunks):
        j0 = c * plan.beams
        j1 = min(fold_k, j0 + plan.beams)
        chunk = []
        for z in range(plan.splits):
            mine = []
            if z < plan.psplits:
                lo = z * plan.tps * TILE
                hi = min((z + 1) * plan.tps * TILE, sp)
                if lo < hi:
                    mine.append(("prompt", lo, hi))
            if (z == plan.splits - 1 if plan.gsplits == 0
                    else z >= plan.psplits):
                if shared_gen:
                    mine += [("gen", None, 0, sg)] if sg else []
                    mine.append(("cand",))
                else:
                    first = j0 if plan.gsplits == 0 else j0 + z - plan.psplits
                    last = j1 if plan.gsplits == 0 else min(first + 1, j1)
                    mine += [("gen", j, 0, sg) for j in range(first, last)
                             if sg]
            chunk.append(mine)
        out.append(chunk)
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def seg_even_odd(seg: torch.Tensor) -> torch.Tensor:
    """(B, S) segment ids -> (B, 2, ceil(S/2)) even/odd planes (an odd tail
    padded with 0 = invalid), the int4 cache's token order."""
    if seg.shape[1] % 2:
        seg = F.pad(seg, (0, 1))
    return torch.stack([seg[:, 0::2], seg[:, 1::2]], dim=1)


def unpack_kv4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S/2, Dh) int8 -> (lo, hi) int32 nibbles in [-8, 7]: the even
    and the odd tokens, by arithmetic shifts of 32-bit values."""
    x = packed.to(torch.int32)
    return (x << 28) >> 28, x >> 4


def _prompt_view(prompt_cache_l: Cache, prompt_seg: torch.Tensor):
    """(k, v, k_scale, v_scale, seg) as llama._decode_attend takes them; an
    int4 cache becomes its even/odd-ordered int8 view (attention does not
    depend on the order of the keys)."""
    if "k4" in prompt_cache_l:
        klo, khi = unpack_kv4(prompt_cache_l["k4"])
        vlo, vhi = unpack_kv4(prompt_cache_l["v4"])
        ks, vs = prompt_cache_l["k_scale"], prompt_cache_l["v_scale"]
        b = prompt_seg.shape[0]
        return (torch.cat([klo, khi], dim=2), torch.cat([vlo, vhi], dim=2),
                torch.cat([ks[:, 0], ks[:, 1]], dim=2),
                torch.cat([vs[:, 0], vs[:, 1]], dim=2),
                seg_even_odd(prompt_seg).reshape(b, -1))
    return (prompt_cache_l["k"], prompt_cache_l["v"],
            prompt_cache_l.get("k_scale"), prompt_cache_l.get("v_scale"),
            prompt_seg)


def decode_attend_plain(
    q: torch.Tensor,  # (B, 1, H, Dh)
    prompt_cache_l: Cache,
    prompt_seg: torch.Tensor,  # (B, Sp) 0 = invalid
    gen_cache_l: Cache,
    gen_valid: torch.Tensor,  # (B, Sg) bool
    beam_k: int = 1,
    bias_p: Optional[torch.Tensor] = None,  # (B items, H, Sp) ALiBi bias
    bias_g: Optional[torch.Tensor] = None,  # (B, H, Sg)
) -> torch.Tensor:
    """The semantics of `_decode_attend` in halva_tpu/models/llama.py: cache values
    convert to q's dtype without their scale, fp32 logits times the k scale,
    one fp32 softmax over the concatenated prompt + gen logits,
    probabilities times the v scale rounded to q's dtype before PV, fp32 PV
    sums. An int4 prompt attends in even/odd token order, as the
    reference's generic decode scan does. Masked keys are selected out, so
    their scales are never read into the result. beam_k > 1: q and the
    gen side carry B*K rows, the prompt side B rows, and row r attends
    prompt row r // K (here by repeating the prompt rows). bias_p and bias_g
    (ALiBi, in the order of the prompt tokens and of the gen slots) are added
    to the logits after the k scale; the K4 and K5 kernels have no
    counterpart of them, so llama.decode_step takes this function for an
    ALiBi step on either device."""
    b, _, h, dh = q.shape
    kp, vp, kps, vps, seg = _prompt_view(prompt_cache_l, prompt_seg)
    if bias_p is not None and "k4" in prompt_cache_l:
        # the int4 view holds the keys in even/odd order (an odd tail padded)
        if bias_p.shape[-1] % 2:
            bias_p = F.pad(bias_p, (0, 1))
        bias_p = torch.cat([bias_p[..., 0::2], bias_p[..., 1::2]], dim=-1)
    if beam_k > 1:
        if kp.shape[0] * beam_k != b:
            raise ValueError(f"beam_k={beam_k}: q has {b} rows, the prompt "
                             f"cache {kp.shape[0]}")
        kp, vp, kps, vps, seg, bias_p = (
            None if t is None else t.repeat_interleave(beam_k, dim=0)
            for t in (kp, vp, kps, vps, seg, bias_p))
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kgs, vgs = gen_cache_l.get("k_scale"), gen_cache_l.get("v_scale")
    kvh, sp = kp.shape[1], kp.shape[2]
    q3 = q[:, 0].reshape(b, kvh, h // kvh, dh).float()  # head-major groups

    def values(t):  # the cache as q's dtype would hold it, computed in fp32
        return t.to(q.dtype).float()

    scale = dh**-0.5
    lp = torch.einsum("bngd,bnkd->bngk", q3, values(kp)) * scale
    if kps is not None:
        lp = lp * kps.float()[:, :, None, :]
    lg = torch.einsum("bngd,bnkd->bngk", q3, values(kg)) * scale
    if kgs is not None:
        lg = lg * kgs.float()[:, :, None, :]
    if bias_p is not None:
        lp = lp + bias_p.float().reshape(b, kvh, h // kvh, sp)
    if bias_g is not None:
        lg = lg + bias_g.float().reshape(b, kvh, h // kvh, kg.shape[2])
    live_p = (seg != 0)[:, None, None, :]
    live_g = gen_valid[:, None, None, :]
    lp = lp.masked_fill(~live_p, NEG_INF)
    lg = lg.masked_fill(~live_g, NEG_INF)
    probs = torch.softmax(torch.cat([lp, lg], dim=-1), dim=-1)
    pp, pg = probs[..., :sp], probs[..., sp:]
    # select, not multiply: a masked key's scale may hold anything
    if vps is not None:
        pp = torch.where(live_p, pp * vps.float()[:, :, None, :], 0.0)
    if vgs is not None:
        pg = torch.where(live_g, pg * vgs.float()[:, :, None, :], 0.0)
    out = torch.einsum("bngk,bnkd->bngd", values(pp), values(vp))
    out = out + torch.einsum("bngk,bnkd->bngd", values(pg), values(vg))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _prompt_tokens(prompt_cache_l: Cache, sp: int):
    """(k, v, k_scale, v_scale) of the prompt cache in token order (an int4
    cache unpacked: token 2r from byte row r's low nibble, 2r + 1 from its
    high one), the order K4's tiles walk."""
    if "k4" not in prompt_cache_l:
        return (prompt_cache_l["k"], prompt_cache_l["v"],
                prompt_cache_l.get("k_scale"), prompt_cache_l.get("v_scale"))

    def tokens(lo_hi):
        x = torch.stack(lo_hi, dim=3)  # (B, KVH, R, 2, D)
        return x.reshape(x.shape[0], x.shape[1], -1, x.shape[-1])[:, :, :sp]

    def scales(s):  # (B, 2, KVH, R) -> (B, KVH, 2R)
        x = torch.stack([s[:, 0], s[:, 1]], dim=-1)
        return x.reshape(x.shape[0], x.shape[1], -1)[..., :sp]

    return (tokens(unpack_kv4(prompt_cache_l["k4"])),
            tokens(unpack_kv4(prompt_cache_l["v4"])),
            scales(prompt_cache_l["k_scale"]),
            scales(prompt_cache_l["v_scale"]))


def _merge(partials):
    """(max in the exp2 domain, denominator, unnormalised accumulator)
    partials -> one, in list order, as K4's last block merges its splits:
    a partial with no visible key (max M_INIT, denominator 0) weighs 0."""
    mx = partials[0][0]
    for m, _, _ in partials[1:]:
        mx = torch.maximum(mx, m)
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(partials[0][2])
    for m, l, a in partials:
        w = torch.exp2(m - mx)
        den = den + w * l
        acc = acc + w[..., None] * a
    return mx, den, acc


def decode_attend_split_plain(
    q: torch.Tensor,  # (B, 1, H, Dh)
    prompt_cache_l: Cache,
    prompt_seg: torch.Tensor,
    gen_cache_l: Cache,
    gen_valid: torch.Tensor,
    plan: Plan,
    beam_k: int = 1,
) -> torch.Tensor:
    """K4's split and merge in plain ops: the function of
    `decode_attend_plain`, computed as the kernel computes it under `plan`
    (`decode_plan`). Each key range of `split_ranges` gives an fp32 partial
    (max of its visible logits in the exp2 domain, or M_INIT; denominator;
    accumulator of probability times v scale times V), the ranges of a
    split merge into its partial, and the splits merge in split order. The
    cache values convert to q's dtype, the probabilities stay fp32, and a
    row with no visible key gives 0, as the kernel does."""
    b, _, h, dh = q.shape
    sp, sg = prompt_seg.shape[1], gen_valid.shape[1]
    kp, vp, kps, vps = _prompt_tokens(prompt_cache_l, sp)
    live_p = prompt_seg != 0
    if beam_k > 1:
        kp, vp, kps, vps, live_p = (
            None if t is None else t.repeat_interleave(beam_k, dim=0)
            for t in (kp, vp, kps, vps, live_p))
    spans = {"prompt": (kp, vp, kps, vps, live_p),
             "gen": (gen_cache_l["k"], gen_cache_l["v"],
                     gen_cache_l.get("k_scale"), gen_cache_l.get("v_scale"),
                     gen_valid)}
    kvh = kp.shape[1]
    qs = q[:, 0].reshape(b, kvh, h // kvh, dh).float() * (
        dh**-0.5 * LOG2E)

    def values(t):  # the cache as q's dtype would hold it, computed in fp32
        return t.to(q.dtype).float()

    def partial(name, lo, hi):
        k, v, ks, vs, live = spans[name]
        s = torch.einsum("bngd,bnkd->bngk", qs, values(k[:, :, lo:hi]))
        vis = live[:, None, None, lo:hi]
        if ks is not None:
            s = s * ks[:, :, None, lo:hi].float()
        m = torch.where(vis, s, M_INIT).amax(-1).clamp_min(M_INIT)
        p = torch.where(vis, torch.exp2(s - m[..., None]), 0.0)
        pw = p if vs is None else torch.where(
            vis, p * vs[:, :, None, lo:hi].float(), 0.0)
        return m, p.sum(-1), torch.einsum("bngk,bnkd->bngd", pw,
                                          values(v[:, :, lo:hi]))

    empty = (torch.full((b, kvh, h // kvh), M_INIT, device=q.device),
             torch.zeros((b, kvh, h // kvh), device=q.device),
             torch.zeros((b, kvh, h // kvh, dh), device=q.device))
    splits = [_merge([empty] + [partial(*r) for r in ranges])
              for ranges in split_ranges(plan, sp, sg)]
    _, den, acc = _merge(splits)
    out = torch.where(den[..., None] > 0, acc / den[..., None], 0.0)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def fold_attend_plain(
    q: torch.Tensor,  # (B, K, H, Dh)
    prompt_cache_l: Cache,  # B item rows
    prompt_seg: torch.Tensor,  # (B, Sp)
    gen_cache_l: Cache,  # B*K rows, or B rows with shared_gen
    gen_valid: torch.Tensor,  # (B*K, Sg) or (B, Sg) bool
    fold_k: int,
    shared_gen: bool = False,
    candidates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K queries per item in one softmax over [prompt | gen | candidates].
    Per-beam gen stage: query (b, j) attends gen row b*K + j, the semantics
    of `_decode_attend` with `beam_k` in halva_tpu/models/llama.py. Shared
    gen stage: one gen row per item, and query i attends the fresh
    candidates j <= i (kc, vc (B, K, KVH, Dh), never read from the cache),
    the semantics of `_verify_attend` there. The arithmetic is
    `decode_attend_plain`'s; a row with no visible key gives 0."""
    b, kq, h, dh = q.shape
    if kq != fold_k:
        raise ValueError(f"fold_k={fold_k} but q has {kq} queries per item")
    if candidates is not None and not shared_gen:
        raise ValueError("candidates come with shared_gen (speculative "
                         "verify); beams keep their tokens in the gen cache")
    kp, vp, kps, vps, seg = _prompt_view(prompt_cache_l, prompt_seg)
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kgs, vgs = gen_cache_l.get("k_scale"), gen_cache_l.get("v_scale")
    kvh, sp, sg = kp.shape[1], kp.shape[2], kg.shape[2]
    gb = 1 if shared_gen else kq
    if kp.shape[0] != b or kg.shape[0] != b * gb or gen_valid.shape != (
            b * gb, sg):
        raise ValueError(
            f"fold_attend: q {tuple(q.shape)} needs {b} prompt rows and "
            f"{b * gb} gen rows, got {kp.shape[0]} and {kg.shape[0]} (valid "
            f"{tuple(gen_valid.shape)})")
    q5 = q.reshape(b, kq, kvh, h // kvh, dh).float()

    def values(t):  # the cache as q's dtype would hold it, computed in fp32
        return t.to(q.dtype).float()

    def per_query(t):  # gen-side (B*gb, ...) -> (B, gb, ...), gb = K or 1
        return None if t is None else t.reshape(b, gb, *t.shape[1:])

    scale = dh**-0.5
    lp = torch.einsum("bqngd,bnsd->bqngs", q5, values(kp)) * scale
    if kps is not None:
        lp = lp * kps.float()[:, None, :, None, :]
    lg = torch.einsum("bqngd,bqnsd->bqngs", q5,
                      values(per_query(kg)).expand(b, kq, kvh, sg, dh)) * scale
    if kgs is not None:
        lg = lg * per_query(kgs).float()[:, :, :, None, :]
    live_p = (seg != 0)[:, None, None, None, :]
    live_g = per_query(gen_valid)[:, :, None, None, :]
    parts = [lp.masked_fill(~live_p, NEG_INF), lg.masked_fill(~live_g, NEG_INF)]
    live_any = live_p.any(-1) | live_g.any(-1)
    if candidates is not None:
        kc, vc = candidates
        lc = torch.einsum("bqngd,bjnd->bqngj", q5, values(kc)) * scale
        idx = torch.arange(kq, device=q.device)
        causal = (idx[:, None] >= idx[None, :])[None, :, None, None, :]
        parts.append(lc.masked_fill(~causal, NEG_INF))
        live_any = live_any | True
    probs = torch.softmax(torch.cat(parts, dim=-1), dim=-1)
    pp, pg, pc = probs[..., :sp], probs[..., sp:sp + sg], probs[..., sp + sg:]
    # select, not multiply: a masked key's scale may hold anything
    if vps is not None:
        pp = torch.where(live_p, pp * vps.float()[:, None, :, None, :], 0.0)
    if vgs is not None:
        pg = torch.where(live_g,
                         pg * per_query(vgs).float()[:, :, :, None, :], 0.0)
    out = torch.einsum("bqngs,bnsd->bqngd", values(pp), values(vp))
    out = out + torch.einsum(
        "bqngs,bqnsd->bqngd", values(pg),
        values(per_query(vg)).expand(b, kq, kvh, sg, dh))
    if candidates is not None:
        out = out + torch.einsum("bqngj,bjnd->bqngd", values(pc), values(vc))
    out = torch.where(live_any[..., None], out, 0.0)
    return out.reshape(b, kq, h, dh).to(q.dtype)



def fold_attend_split_plain(
    q: torch.Tensor,  # (B, K, H, Dh)
    prompt_cache_l: Cache,
    prompt_seg: torch.Tensor,
    gen_cache_l: Cache,
    gen_valid: torch.Tensor,
    fold_k: int,
    plan: FoldPlan,
    shared_gen: bool = False,
    candidates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K5's split and merge in plain ops: the function of
    `fold_attend_plain`, computed as the kernel computes it under `plan`
    (`fold_plan`). Query row r = beam * G + g of an item lies in chunk r //
    FOLD_ROWS; each key range of the chunk's splits (`fold_split_ranges`)
    gives an fp32 partial of those rows (max of the visible logits in the
    exp2 domain, or M_INIT; denominator; accumulator of probability times v
    scale times V), the ranges of a split merge into its partial and the
    splits merge in split order, as `decode_attend_split_plain` does for
    K4. The cache values convert to q's dtype, the probabilities stay fp32,
    and a row with no visible key gives 0."""
    b, kq, h, dh = q.shape
    sp, sg = prompt_seg.shape[1], gen_valid.shape[1]
    kp, vp, kps, vps = _prompt_tokens(prompt_cache_l, sp)
    kvh = kp.shape[1]
    grp = h // kvh
    rows = kq * grp
    live_p = prompt_seg != 0
    qs = (q.reshape(b, kq, kvh, grp, dh).permute(0, 2, 1, 3, 4)
          .reshape(b, kvh, rows, dh).float() * (dh**-0.5 * LOG2E))
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kgs, vgs = gen_cache_l.get("k_scale"), gen_cache_l.get("v_scale")
    beam_of = torch.arange(rows, device=q.device) // grp

    def values(t):  # the cache as q's dtype would hold it, computed in fp32
        return t.to(q.dtype).float()

    def gen_row(t, j):  # beam j's gen row of every item (None: the shared one)
        if t is None or j is None:
            return t
        return t.reshape(b, kq, *t.shape[1:])[:, j]

    def partial(rs, span):
        """(max, denominator, accumulator) of rows rs over one key range."""
        qr = qs[:, :, rs]
        if span[0] == "prompt":
            lo, hi = span[1:]
            k, v = kp[:, :, lo:hi], vp[:, :, lo:hi]
            ks = None if kps is None else kps[:, :, lo:hi]
            vs = None if vps is None else vps[:, :, lo:hi]
            vis = live_p[:, None, None, lo:hi]
        elif span[0] == "gen":
            j = span[1]
            k, v, ks, vs = (gen_row(t, j) for t in (kg, vg, kgs, vgs))
            vis = gen_row(gen_valid, j)[:, None, None, :]
            if j is not None:  # only beam j's rows see its gen row
                vis = vis & (beam_of[rs] == j)[None, None, :, None]
        else:
            k, v = (t.transpose(1, 2) for t in candidates)
            ks = vs = None
            cand = torch.arange(kq, device=q.device)
            vis = (cand[None, :] <= beam_of[rs][:, None])[None, None]
        s = torch.einsum("bnrd,bnkd->bnrk", qr, values(k))
        if ks is not None:
            s = s * ks[:, :, None, :].float()
        m = torch.where(vis, s, M_INIT).amax(-1).clamp_min(M_INIT)
        p = torch.where(vis, torch.exp2(s - m[..., None]), 0.0)
        pw = p if vs is None else torch.where(
            vis, p * vs[:, :, None, :].float(), 0.0)
        return m, p.sum(-1), torch.einsum("bnrk,bnkd->bnrd", pw, values(v))

    out = []
    for c, chunk in enumerate(fold_split_ranges(plan, sp, sg, fold_k,
                                                shared_gen)):
        rs = slice(c * FOLD_ROWS, min(rows, (c + 1) * FOLD_ROWS))
        n = rs.stop - rs.start
        empty = (torch.full((b, kvh, n), M_INIT, device=q.device),
                 torch.zeros((b, kvh, n), device=q.device),
                 torch.zeros((b, kvh, n, dh), device=q.device))
        splits = [_merge([empty] + [partial(rs, r) for r in ranges
                                    if r[0] != "cand" or candidates])
                  for ranges in chunk]
        _, den, acc = _merge(splits)
        out.append(torch.where(den[..., None] > 0, acc / den[..., None], 0.0))
    o = torch.cat(out, dim=2).reshape(b, kvh, kq, grp, dh)
    return o.permute(0, 2, 1, 3, 4).reshape(b, kq, h, dh).to(q.dtype)

def _mode(prompt_cache_l: Cache, gen_cache_l: Cache) -> str:
    gen8 = "k_scale" in gen_cache_l
    if "k4" in prompt_cache_l and gen8:
        return KERNEL_KV4
    if "k_scale" in prompt_cache_l and "k4" not in prompt_cache_l and gen8:
        return KERNEL_KV8
    if "k_scale" not in prompt_cache_l and "k4" not in prompt_cache_l and (
            not gen8):
        return KERNEL
    raise ValueError(
        "decode attention: the kernels take bf16/bf16, int8/int8 or "
        f"int4/int8 prompt/gen caches, got prompt {sorted(prompt_cache_l)} "
        f"gen {sorted(gen_cache_l)}"
    )


def _kernel_inputs(name, q, prompt_cache_l, prompt_seg, gen_cache_l,
                   gen_valid, prompt_rows, gen_rows, extra=()):
    """Check what a kernel is given (device, types, shapes, contiguity,
    alignment) and return (mode, kp, vp, kg, vg, scales, sp_rows). q is
    (rows, queries, H, 128); the prompt side has `prompt_rows` rows, the gen
    side `gen_rows`; `extra` are further bf16 tensors of the launch."""
    mode = _mode(prompt_cache_l, gen_cache_l)
    h, d = q.shape[2], q.shape[3]
    sp = prompt_seg.shape[1]
    kp = prompt_cache_l["k4" if mode == KERNEL_KV4 else "k"]
    vp = prompt_cache_l["v4" if mode == KERNEL_KV4 else "v"]
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kvh, sp_rows, sg = kp.shape[1], kp.shape[2], kg.shape[2]
    quant = mode != KERNEL
    scales = ((prompt_cache_l["k_scale"], prompt_cache_l["v_scale"],
               gen_cache_l["k_scale"], gen_cache_l["v_scale"])
              if quant else ())
    tensors = (q, kp, vp, prompt_seg, kg, vg, gen_valid, *scales, *extra)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    cache_dt = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or any(
            t.dtype != cache_dt for t in (kp, vp, kg, vg)) or any(
            t.dtype != torch.bfloat16 for t in (*scales, *extra)):
        raise TypeError(f"{name} ({mode}): q bf16, caches {cache_dt}, "
                        "scales and candidates bf16")
    if prompt_seg.dtype != torch.int32 or gen_valid.dtype != torch.bool:
        raise TypeError(f"{name}: prompt_seg int32, gen_valid bool")
    want_rows = -(-sp // 2) if mode == KERNEL_KV4 else sp
    pscale = ((prompt_rows, 2, kvh, sp_rows) if mode == KERNEL_KV4 else
              (prompt_rows, kvh, sp_rows))
    if (
        h % kvh
        or h // kvh not in (1, 2, 4, 8)
        or d != 128
        or sp_rows != want_rows
        or kp.shape != (prompt_rows, kvh, sp_rows, d)
        or vp.shape != kp.shape
        or kg.shape != (gen_rows, kvh, sg, d)
        or vg.shape != kg.shape
        or prompt_seg.shape != (prompt_rows, sp)
        or gen_valid.shape != (gen_rows, sg)
        or (quant and (scales[0].shape != pscale
                       or scales[1].shape != pscale
                       or scales[2].shape != (gen_rows, kvh, sg)
                       or scales[3].shape != (gen_rows, kvh, sg)))
    ):
        raise ValueError(
            f"{name} ({mode}): unsupported shapes q {tuple(q.shape)} prompt "
            f"{tuple(kp.shape)} gen {tuple(kg.shape)} seg "
            f"{tuple(prompt_seg.shape)} valid {tuple(gen_valid.shape)} "
            f"scales {[tuple(t.shape) for t in scales]}"
        )
    if any(not t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, kp, vp, kg, vg, *extra)
    ):
        raise ValueError(f"{name}: inputs must be contiguous, q, caches and "
                         "candidates 16-byte aligned")
    return mode, kp, vp, kg, vg, scales, sp_rows


def fold_attend_layer(
    q: torch.Tensor,  # (B, K, H, Dh)
    prompt_cache_l: Cache,
    prompt_seg: torch.Tensor,
    gen_cache_l: Cache,
    gen_valid: torch.Tensor,
    fold_k: int,
    shared_gen: bool = False,
    candidates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """(B, K, H, Dh) attention output of K queries per item for one layer
    (K5); see `fold_attend_plain` for the function computed. `splits`
    forces the aim of K5's plan (`fold_plan`) instead of the SM count's;
    the function computed is the same."""
    if q.device.type == "cpu":
        return fold_attend_plain(q, prompt_cache_l, prompt_seg, gen_cache_l,
                                 gen_valid, fold_k, shared_gen, candidates)
    b, kq, h, d = q.shape
    if kq != fold_k or not 2 <= fold_k <= 8:
        raise ValueError(f"fold_attend_layer: fold_k={fold_k} (2..8) but q "
                         f"has {kq} queries per item")
    if candidates is not None and not shared_gen:
        raise ValueError("fold_attend_layer: candidates come with shared_gen")
    extra = tuple(candidates) if candidates is not None else ()
    mode, kp, vp, kg, vg, scales, sp_rows = _kernel_inputs(
        "fold_attend_layer", q, prompt_cache_l, prompt_seg, gen_cache_l,
        gen_valid, b, b if shared_gen else b * fold_k, extra)
    kvh, sg = kp.shape[1], kg.shape[2]
    sp = prompt_seg.shape[1]
    if any(t.shape != (b, fold_k, kvh, d) for t in extra):
        raise ValueError("fold_attend_layer: candidates must be "
                         f"{(b, fold_k, kvh, d)}, got "
                         f"{[tuple(t.shape) for t in extra]}")
    name = FOLD[mode] + (SHARED_SUFFIX if shared_gen else "")
    grp = h // kvh
    plan = fold_plan(b, kvh, fold_k * grp, grp, sp, sg, sm_count(q.device),
                     shared_gen, splits)
    work = b * plan.chunks * kvh
    if plan.splits > 1 and work > _kernels.MAX_TICKETS:
        raise ValueError(f"fold_attend_layer: {work} (item, chunk, kv head) "
                         f"work items exceed {_kernels.MAX_TICKETS} tickets")
    o = torch.empty_like(q)
    # per split: fp32 accumulator (16 x D), running max and denominator (16)
    part = torch.empty(work * plan.splits * FOLD_ROWS * (d + 2)
                       if plan.splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    ptr = [t.data_ptr() for t in scales] or [None] * 4
    cand = [t.data_ptr() for t in extra] or [None, None]
    fmt = (KERNEL, KERNEL_KV8, KERNEL_KV4).index(mode)
    lib = _kernels.lib()
    with torch.cuda.device(q.device):
        err = lib.halva_fold_attn(
            fmt, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ptr[0], ptr[1],
            prompt_seg.data_ptr(), kg.data_ptr(), vg.data_ptr(), ptr[2],
            ptr[3], gen_valid.data_ptr(), cand[0], cand[1], o.data_ptr(),
            part.data_ptr(), _kernels.tickets(q.device).data_ptr(),
            b, fold_k, h, kvh, sp, sp_rows, sg, d, int(shared_gen),
            plan.psplits, plan.tps, plan.gsplits, float(d**-0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(err, name)
    _kernels.launches[name] += 1
    return o


def auto_beam_route(prompt_cache_l: Cache, prompt_seg: torch.Tensor,
                    beam_k: int) -> str:
    """The beam route `beam_route="auto"` takes, from the shapes alone (the
    reference has no such choice, and no route changes a token): K5
    ("fold") where the layer's prompt cache (values and scales) outgrows
    FOLD_MIN_PROMPT_BYTES, half the H100's 50 MB L2, so that K4's beam mode
    would read it from device memory once per beam; K4's beam mode
    ("grid") below that, where its re-reads come from the L2, and for a
    beam count K5 does not take (2..8). Measured on the card
    (`chip_smoke.py --fold-only`): K5 wins at 4 items of bf16 caches and at
    80 items in every format, K4's beam mode at 4 items of int8 and int4
    caches and under GQA."""
    if not 2 <= beam_k <= 8:
        return "grid"
    nbytes = sum(t.numel() * t.element_size()
                 for t in prompt_cache_l.values())
    return "fold" if nbytes > FOLD_MIN_PROMPT_BYTES else "grid"


def decode_attend_layer(
    q: torch.Tensor,
    prompt_cache_l: Cache,
    prompt_seg: torch.Tensor,
    gen_cache_l: Cache,
    gen_valid: torch.Tensor,
    beam_k: int = 1,
    beam_route: str = "auto",
    splits: Optional[int] = None,
) -> torch.Tensor:
    """(B, 1, H, Dh) attention output of one decode step for one layer.
    beam_k > 1: B = items * beam_k rows against an items-row prompt cache,
    through K5 (`beam_route="fold"`), K4's beam mode ("grid"), or the one
    `auto_beam_route` picks from the shapes ("auto"). `splits` forces the
    aim of the kernel's plan (`decode_plan` or `fold_plan`) instead of the
    SM count's; the function computed is the same."""
    if beam_route not in BEAM_ROUTES:
        raise ValueError(f"beam_route must be one of {BEAM_ROUTES}, got "
                         f"{beam_route!r}")
    if q.device.type == "cpu":
        return decode_attend_plain(
            q, prompt_cache_l, prompt_seg, gen_cache_l, gen_valid, beam_k
        )
    b, one, h, d = q.shape
    if one != 1 or beam_k < 1 or b % beam_k:
        raise ValueError(f"decode_attend_layer: q {tuple(q.shape)} must be "
                         f"(B, 1, H, Dh) with B a multiple of beam_k={beam_k}")
    if beam_route == "auto":
        beam_route = auto_beam_route(prompt_cache_l, prompt_seg, beam_k)
    if beam_k > 1 and beam_route == "fold":
        out = fold_attend_layer(
            q.reshape(b // beam_k, beam_k, h, d), prompt_cache_l, prompt_seg,
            gen_cache_l, gen_valid, fold_k=beam_k, splits=splits)
        return out.reshape(b, 1, h, d)
    mode, kp, vp, kg, vg, scales, sp_rows = _kernel_inputs(
        "decode_attend_layer", q, prompt_cache_l, prompt_seg, gen_cache_l,
        gen_valid, b // beam_k, b)
    kvh, sg = kp.shape[1], kg.shape[2]
    sp = prompt_seg.shape[1]
    name = mode + (BEAM_SUFFIX if beam_k > 1 else "")
    n_split, tps = decode_plan(b, kvh, sp, sg, sm_count(q.device), splits)
    if n_split > 1 and b * kvh > _kernels.MAX_TICKETS:
        raise ValueError(f"decode_attend_layer: {b * kvh} (row, kv head) "
                         f"pairs exceed {_kernels.MAX_TICKETS} tickets")
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    # per split: fp32 accumulator (G x D), running max and denominator (G)
    part = torch.empty(b * n_split * h * (d + 2) if n_split > 1 else 0,
                       dtype=torch.float32, device=q.device)
    scratch = (part.data_ptr(), _kernels.tickets(q.device).data_ptr())
    lib = _kernels.lib()
    scale = float(d**-0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == KERNEL:
            err = lib.halva_decode_attn_bf16(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                prompt_seg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                gen_valid.data_ptr(), o.data_ptr(), *scratch,
                b, h, kvh, sp, sg, d, beam_k, n_split, tps, scale, stream,
            )
        else:
            ptrs = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    scales[0].data_ptr(), scales[1].data_ptr(),
                    prompt_seg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                    scales[2].data_ptr(), scales[3].data_ptr(),
                    gen_valid.data_ptr(), o.data_ptr(), *scratch)
            if mode == KERNEL_KV8:
                err = lib.halva_decode_attn_kv8(
                    *ptrs, b, h, kvh, sp, sg, d, beam_k, n_split, tps, scale,
                    stream)
            else:
                err = lib.halva_decode_attn_kv4(
                    *ptrs, b, h, kvh, sp, sp_rows, sg, d, beam_k, n_split,
                    tps, scale, stream)
    _kernels.check(err, name)
    _kernels.launches[name] += 1
    return o
