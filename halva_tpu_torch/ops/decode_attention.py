"""K4: fused decode attention (CUDA, csrc/decode_attn.cu) and its plain version.

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
reads such rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from halva_tpu_torch import _kernels

KERNEL = "decode_attn"
KERNEL_KV8 = "decode_attn_kv8"
KERNEL_KV4 = "decode_attn_kv4"
NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


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
) -> torch.Tensor:
    """The semantics of halva_tpu.models.llama._decode_attend: cache values
    convert to q's dtype without their scale, fp32 logits times the k scale,
    one fp32 softmax over the concatenated prompt + gen logits,
    probabilities times the v scale rounded to q's dtype before PV, fp32 PV
    sums. An int4 prompt attends in even/odd token order, as the
    reference's generic decode scan does. Masked keys are selected out, so
    their scales are never read into the result."""
    b, _, h, dh = q.shape
    kp, vp, kps, vps, seg = _prompt_view(prompt_cache_l, prompt_seg)
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
        "decode_attend_layer: the kernel takes bf16/bf16, int8/int8 or "
        f"int4/int8 prompt/gen caches, got prompt {sorted(prompt_cache_l)} "
        f"gen {sorted(gen_cache_l)}"
    )


def decode_attend_layer(
    q: torch.Tensor,
    prompt_cache_l: Cache,
    prompt_seg: torch.Tensor,
    gen_cache_l: Cache,
    gen_valid: torch.Tensor,
) -> torch.Tensor:
    """(B, 1, H, Dh) attention output of one decode step for one layer."""
    if q.device.type == "cpu":
        return decode_attend_plain(
            q, prompt_cache_l, prompt_seg, gen_cache_l, gen_valid
        )
    mode = _mode(prompt_cache_l, gen_cache_l)
    b, one, h, d = q.shape
    sp = prompt_seg.shape[1]
    kp = prompt_cache_l["k4" if mode == KERNEL_KV4 else "k"]
    vp = prompt_cache_l["v4" if mode == KERNEL_KV4 else "v"]
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kvh, sp_rows, sg = kp.shape[1], kp.shape[2], kg.shape[2]
    quant = mode != KERNEL
    scales = ((prompt_cache_l["k_scale"], prompt_cache_l["v_scale"],
               gen_cache_l["k_scale"], gen_cache_l["v_scale"])
              if quant else ())
    tensors = (q, kp, vp, prompt_seg, kg, vg, gen_valid, *scales)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("decode_attend_layer: all inputs on one CUDA device")
    cache_dt = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or any(
            t.dtype != cache_dt for t in (kp, vp, kg, vg)) or any(
            t.dtype != torch.bfloat16 for t in scales):
        raise TypeError(f"decode_attend_layer ({mode}): q bf16, caches "
                        f"{cache_dt}, scales bf16")
    if prompt_seg.dtype != torch.int32 or gen_valid.dtype != torch.bool:
        raise TypeError("decode_attend_layer: prompt_seg int32, gen_valid bool")
    want_rows = -(-sp // 2) if mode == KERNEL_KV4 else sp
    pscale = ((b, 2, kvh, sp_rows) if mode == KERNEL_KV4 else
              (b, kvh, sp_rows))
    if (
        one != 1
        or h % kvh
        or h // kvh not in (1, 2, 4, 8)
        or d != 128
        or sp_rows != want_rows
        or kp.shape != (b, kvh, sp_rows, d)
        or vp.shape != kp.shape
        or kg.shape != (b, kvh, sg, d)
        or vg.shape != kg.shape
        or prompt_seg.shape != (b, sp)
        or gen_valid.shape != (b, sg)
        or (quant and (scales[0].shape != pscale
                       or scales[1].shape != pscale
                       or scales[2].shape != (b, kvh, sg)
                       or scales[3].shape != (b, kvh, sg)))
    ):
        raise ValueError(
            f"decode_attend_layer ({mode}): unsupported shapes q "
            f"{tuple(q.shape)} prompt {tuple(kp.shape)} gen {tuple(kg.shape)} "
            f"seg {tuple(prompt_seg.shape)} valid {tuple(gen_valid.shape)} "
            f"scales {[tuple(t.shape) for t in scales]}"
        )
    if any(not t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, kp, vp, kg, vg)
    ):
        raise ValueError("decode_attend_layer: inputs must be contiguous, "
                         "q and caches 16-byte aligned")
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = _kernels.lib()
    scale = float(d**-0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == KERNEL:
            err = lib.halva_decode_attn_bf16(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                prompt_seg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                gen_valid.data_ptr(), o.data_ptr(),
                b, h, kvh, sp, sg, d, scale, stream,
            )
        else:
            ptrs = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    scales[0].data_ptr(), scales[1].data_ptr(),
                    prompt_seg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                    scales[2].data_ptr(), scales[3].data_ptr(),
                    gen_valid.data_ptr(), o.data_ptr())
            if mode == KERNEL_KV8:
                err = lib.halva_decode_attn_kv8(
                    *ptrs, b, h, kvh, sp, sg, d, scale, stream)
            else:
                err = lib.halva_decode_attn_kv4(
                    *ptrs, b, h, kvh, sp, sp_rows, sg, d, scale, stream)
    _kernels.check(err, mode)
    _kernels.launches[mode] += 1
    return o
