"""K4: fused decode attention (CUDA, csrc/decode_attn.cu) and its plain version.

Counterpart of halva_tpu/ops/decode_attention.py, bf16 caches. One query
per row attends the layer's prompt cache (keys with segment id != 0) and
its generated-token cache (slots with gen_valid) in one softmax. Caches are
head-major (B, KVH, S, D): the caller passes the layer slice `cache[li]`,
which in torch is a view, so the reference's "whole stacked cache plus
scalar-prefetch layer index" needs no counterpart here.

`decode_attend_layer` launches the kernel for CUDA tensors and uses
`decode_attend_plain` for CPU tensors; on a CUDA tensor it launches or
raises. Rows with no visible key: the kernel gives 0 (as the Pallas
kernel), the plain version a uniform average (as llama._decode_attend);
no caller reads such rows.
"""

from __future__ import annotations

from typing import Dict

import torch

from halva_tpu_torch import _kernels

KERNEL = "decode_attn"
NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


def decode_attend_plain(
    q: torch.Tensor,  # (B, 1, H, Dh)
    prompt_cache_l: Cache,  # {k, v}: (B, KVH, Sp, Dh)
    prompt_seg: torch.Tensor,  # (B, Sp) 0 = invalid
    gen_cache_l: Cache,  # {k, v}: (B, KVH, Sg, Dh)
    gen_valid: torch.Tensor,  # (B, Sg) bool
) -> torch.Tensor:
    """The semantics of halva_tpu.models.llama._decode_attend (bf16 caches):
    fp32 logits and softmax over the concatenated prompt + gen logits,
    probabilities rounded to q's dtype before PV, fp32 PV sums."""
    b, _, h, dh = q.shape
    kp, vp = prompt_cache_l["k"], prompt_cache_l["v"]
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kvh, sp = kp.shape[1], kp.shape[2]
    q3 = q[:, 0].reshape(b, kvh, h // kvh, dh).float()  # head-major groups
    scale = dh**-0.5
    lp = torch.einsum("bngd,bnkd->bngk", q3, kp.float()) * scale
    lg = torch.einsum("bngd,bnkd->bngk", q3, kg.float()) * scale
    lp = lp.masked_fill((prompt_seg == 0)[:, None, None, :], NEG_INF)
    lg = lg.masked_fill(~gen_valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(torch.cat([lp, lg], dim=-1), dim=-1)
    probs = probs.to(q.dtype).float()
    out = torch.einsum("bngk,bnkd->bngd", probs[..., :sp], vp.float())
    out = out + torch.einsum("bngk,bnkd->bngd", probs[..., sp:], vg.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


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
    b, one, h, d = q.shape
    kp, vp = prompt_cache_l["k"], prompt_cache_l["v"]
    kg, vg = gen_cache_l["k"], gen_cache_l["v"]
    kvh, sp, sg = kp.shape[1], kp.shape[2], kg.shape[2]
    tensors = (q, kp, vp, prompt_seg, kg, vg, gen_valid)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("decode_attend_layer: all inputs on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, kp, vp, kg, vg)):
        raise TypeError("decode_attend_layer: q and caches must be bfloat16 "
                        "(int8/int4 caches are not ported yet)")
    if prompt_seg.dtype != torch.int32 or gen_valid.dtype != torch.bool:
        raise TypeError("decode_attend_layer: prompt_seg int32, gen_valid bool")
    if (
        one != 1
        or h % kvh
        or h // kvh not in (1, 2, 4, 8)
        or d != 128
        or kp.shape != (b, kvh, sp, d)
        or vp.shape != kp.shape
        or kg.shape != (b, kvh, sg, d)
        or vg.shape != kg.shape
        or prompt_seg.shape != (b, sp)
        or gen_valid.shape != (b, sg)
    ):
        raise ValueError(
            f"decode_attend_layer: unsupported shapes q {tuple(q.shape)} "
            f"prompt {tuple(kp.shape)} gen {tuple(kg.shape)} "
            f"seg {tuple(prompt_seg.shape)} valid {tuple(gen_valid.shape)}"
        )
    if any(not t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, kp, vp, kg, vg)
    ):
        raise ValueError("decode_attend_layer: inputs must be contiguous, "
                         "q and caches 16-byte aligned")
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_decode_attn_bf16(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), prompt_seg.data_ptr(),
            kg.data_ptr(), vg.data_ptr(), gen_valid.data_ptr(), o.data_ptr(),
            b, h, kvh, sp, sg, d, float(d**-0.5), stream,
        )
    _kernels.check(err, KERNEL)
    _kernels.launches[KERNEL] += 1
    return o
