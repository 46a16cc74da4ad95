"""Packed int4 weights: quantizers, the prefill matmuls, K6, the decode
GEMV (CUDA, csrc/w4_gemv.cu), and K7, the M-tiled GEMM (CUDA,
csrc/dq_gemm.cu), each with its plain version.

Counterpart of halva_tpu/ops/w4_matmul.py, single device (tp=1). Storage is
the reference's: two int4 values per int8 byte, split-half, so byte [k, j]
holds channel j in its low nibble and channel j + N/2 in its high nibble;
`kernel_scale4p` (2, G, N/2) bf16 scales the two halves, one scale per
output channel (G = 1) or per group of K/G input rows. Quantization is
symmetric absmax/7 with values in [-7, 7]; unpacking sign-extends, so any
byte (also -8) is a valid weight.

`w4_dense_stacked` takes one layer slice `{kernel_q4p (K, N/2),
kernel_scale4p (2, G, N/2)}` (a view of the stacked tree): torch needs no
counterpart of the reference's scalar-prefetch layer index. It launches K6
for CUDA tensors and uses `w4_dense_stacked_plain` for CPU tensors; on a
CUDA tensor it launches or raises.

`w4_gemm` is the same function for any number of rows, differentiable in
x (the train step on a frozen int4 base): K7 for CUDA tensors,
`w4_gemm_plain` for CPU tensors. Up to 32 rows K6 and K7 run one loop
(csrc/dq_rows.cuh); above, K6 streams the weights once per 32-row chunk,
K7 once: `w4_decode_matmul` sends a decode-family matmul with more than
`W4_GEMV_MAX_ROWS` rows (beams, verify steps, large batches) to K7 and the
rest to K6, and so does it with shapes K7 refuses (scale groups that are no
multiple of its 64-row K tile) at any row count: `w4_route` decides from
the shapes alone. `w4_dense_stacked_split_plain` and `w4_gemm_split_plain`
are that loop's arithmetic in torch ops, for the tests.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops import quant
from halva_tpu_torch.ops.int8_matmul import (
    ROW_CHUNKS,
    ROWS_TILE_BYTES,
    ROWS_TILE_K,
    ROWS_WARPS,
    SM_COUNT,
    TILE_K,
    GemmPlan,
    check_gemm_inputs,
    gemm_plan,
    launch_dq_gemm,
    row_chunk,
    row_ranges,
    rows_splits,
    split_sum_plain,
)

KERNEL = "w4_gemv"
GEMM_KERNEL = "w4_gemm"
# rows up to which a decode-family matmul takes K6 (its row chunk), above
# which K7. 8 or 16, never more: a verify step at draft_k 8 (32 rows) takes
# K7 whatever the measurements at 16 rows say.
W4_GEMV_MAX_ROWS = 8

Params = Dict[str, Any]

# K6 geometry: the decode-row loop of csrc/dq_rows.cuh. A block of
# ROWS_WARPS warps owns TILE_NP packed columns, a chunk of up to 32 rows of
# x and a split of K in tiles of K_TILE rows.
TILE_NP = ROWS_TILE_BYTES
K_TILE = ROWS_TILE_K
MIN_WARP_TILES = 2  # K tiles each warp of a split gets at the least


def quantize_kernel_int4_stacked(
    w: torch.Tensor, group_size: Optional[int] = None, tp: int = 1
) -> Dict[str, torch.Tensor]:
    """(L, K, N) float -> {kernel_q4p (L, K, N/2) int8, kernel_scale4p
    (L, 2, G, N/2) bf16}; G = 1 (group_size None) or K / group_size."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel int4 packing (tp > 1) is not ported yet "
            "(ROADMAP queue 1 item 10, multi-GPU)"
        )
    nl, k, n = w.shape
    if n % 2:
        raise ValueError(f"int4 packing needs an even output dim, got {n}")
    g = k if group_size is None else group_size
    if k % g:
        raise ValueError(f"group size {g} does not divide K={k}")
    w32 = w.float().reshape(nl, k // g, g, n)
    absmax = w32.abs().amax(dim=-2, keepdim=True)  # (L, G, 1, N)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int32)
    q = q.reshape(nl, k, n)
    packed = ((q[:, :, n // 2:] & 0xF) << 4) | (q[:, :, : n // 2] & 0xF)
    packed = (packed - 256 * (packed > 127).to(torch.int32)).to(torch.int8)
    # (L, G, 1, N) -> (L, 2, G, N/2): [:, h] scales channel half h
    s = scale.reshape(nl, k // g, 2, n // 2).permute(0, 2, 1, 3)
    return {"kernel_q4p": packed,
            "kernel_scale4p": s.to(torch.bfloat16).contiguous()}


def quantize_params_int4(params: Params, group_size: Optional[int] = None,
                         tp: int = 1) -> Params:
    """The int4 serving tree: every stacked 3-D kernel (LLM and vision
    layers) -> packed int4, then 2-D kernels and vocab tables -> int8
    (quant.quantize_params). Stacks whose K the group size does not divide
    keep per-channel scales. Sibling leaves (biases) are kept; the input
    tree is not modified. Same leaves, bytes and scale bits as the
    reference's quantize_params_int4_host."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel int4 packing (tp > 1) is not ported yet "
            "(ROADMAP queue 1 item 10, multi-GPU)"
        )

    def rewrite(node):
        if isinstance(node, (list, tuple)):
            return type(node)(rewrite(x) for x in node)
        if not isinstance(node, dict):
            return node
        k3 = node.get("kernel")
        if isinstance(k3, torch.Tensor) and k3.ndim == 3:
            g = group_size
            if g is not None and k3.shape[1] % g:
                g = None
            out = {k: v for k, v in node.items() if k != "kernel"}
            out.update(quantize_kernel_int4_stacked(k3, group_size=g))
            return out
        return {k: rewrite(v) for k, v in node.items()}

    return quant.quantize_params(rewrite(params))


def unpack_int4(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 packed bytes -> (lo, hi) sign-extended int32 nibbles in
    [-8, 7], by arithmetic shifts of 32-bit values."""
    p32 = p.to(torch.int32)
    return (p32 << 28) >> 28, p32 >> 4


def dequantize_int4(kernel_q4p: torch.Tensor, kernel_scale4p: torch.Tensor,
                    dtype) -> torch.Tensor:
    """(K, N/2) packed + (2, G, N/2) scales -> (K, N) weights: nibble and
    scale each cast to `dtype`, multiplied in `dtype` (the reference's
    dense dequant branch)."""
    lo, hi = unpack_int4(kernel_q4p)
    s = kernel_scale4p.to(dtype)
    ng = s.shape[1]
    if ng > 1:
        s = s.repeat_interleave(lo.shape[0] // ng, dim=1)  # (2, K, N/2)
    return torch.cat([lo.to(dtype) * s[0], hi.to(dtype) * s[1]], dim=-1)


def w4a8_dense(x: torch.Tensor, kernel_q4p: torch.Tensor,
               kernel_scale4p: torch.Tensor) -> torch.Tensor:
    """W4A8 prefill matmul: nibbles unpacked to int8, per-token int8
    activations (quant.int8_dense's scheme), exact s32 dots. G = 1: one
    dot, y = acc * sx * sw. G > 1: one dot per group of K/G rows, each
    group's weight scale folded into its fp32 partial before the sum."""
    ng = kernel_scale4p.shape[1]
    lo, hi = unpack_int4(kernel_q4p)
    wq = torch.cat([lo, hi], dim=-1).to(torch.int8)  # (K, N)
    sw = torch.cat([kernel_scale4p[0], kernel_scale4p[1]], dim=-1).float()
    lead, k = x.shape[:-1], x.shape[-1]
    xq, sx = quant.quantize_rows_int8(x.reshape(-1, k))
    if ng == 1:
        y = quant.int_matmul(xq, wq).float() * sx * sw
        return y.to(x.dtype).reshape(*lead, -1)
    gs = k // ng
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=x.device)
    for g in range(ng):
        d = quant.int_matmul(xq[:, g * gs:(g + 1) * gs],
                             wq[g * gs:(g + 1) * gs])
        acc = acc + d.float() * sw[g][None, :]
    return (acc * sx).to(x.dtype).reshape(*lead, -1)


def plain_weights(kernel_q4p: torch.Tensor, kernel_scale4p: torch.Tensor,
                  dtype) -> torch.Tensor:
    """(K, N) fp32 weights as the Pallas kernel multiplies them: nibble *
    scale in fp32 (exact: 4-bit by 8-bit mantissas), rounded to `dtype` (x's)
    for grouped scales (G > 1), which scale the weights before the dot; per
    channel (G = 1) the exact product, the scale of the dot's output."""
    w = dequantize_int4(kernel_q4p, kernel_scale4p, torch.float32)
    return w.to(dtype).float() if kernel_scale4p.shape[1] > 1 else w


def w4_dense_stacked_plain(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y (B, N) = x (B, K) @ dequant(p): the weights of `plain_weights`, one
    fp32 matmul, cast to x's dtype."""
    w = plain_weights(p["kernel_q4p"], p["kernel_scale4p"], x.dtype)
    return (x.float() @ w).to(x.dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def odd_groups(k: int, groups: int) -> bool:
    """Grouped scales whose groups are no multiple of K_TILE rows: K6 reads
    those weights' scales from device memory (csrc/dq_rows.cuh, W4_ODD),
    8 rows a chunk."""
    return groups > 1 and (k // groups) % K_TILE != 0


def plan(b: int, k: int, np_: int, groups: int = 1,
         sms: int = SM_COUNT) -> Tuple[int, int, int]:
    """K6 launch plan: (rows per chunk, K splits, rows per split), a pure
    function of the shapes and the SM count.

    Rows of x go in chunks of 8, 16 or 32 (one to four n8 tiles of
    mma.sync; 8 for odd groups); K is split by `rows_splits` (the count
    that finishes first on `sms` SMs), each split a multiple of K_TILE rows
    and at most so many that every warp of a split gets MIN_WARP_TILES K
    tiles. No split is empty. A split's partial sums are reduced by the
    last of its blocks to finish (csrc/dq_rows.cuh)."""
    rc = ROW_CHUNKS[0] if odd_groups(k, groups) else row_chunk(b)
    blocks = _cdiv(np_, TILE_NP) * _cdiv(b, rc)
    kt = _cdiv(k, K_TILE)
    most = max(1, kt // (ROWS_WARPS * MIN_WARP_TILES))
    splits, tps = rows_splits(blocks, kt, 1, most, sms)
    return rc, splits, tps * K_TILE


def _w4_split_plain(x2: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                    ranges) -> torch.Tensor:
    """The decode-row loop's arithmetic for packed int4 (csrc/dq_rows.cuh):
    the weights as the tensor cores get them (nibbles; with G > 1 nibble *
    scale in fp32, rounded to x's dtype, the Pallas kernel's rounding),
    summed in fp32 in the loop's K ranges and merge order, times the
    channel scale for G = 1, cast to x's dtype."""
    ng = s.shape[1]
    if ng == 1:
        wt = dequantize_int4(w, torch.ones_like(s), torch.float32)
    else:
        wt = plain_weights(w, s, x2.dtype)
    y = split_sum_plain(x2, wt, ranges)
    if ng == 1:
        y = y * torch.cat([s[0, 0], s[1, 0]]).float()
    return y.to(x2.dtype)


def w4_dense_stacked_split_plain(x: torch.Tensor, p: Params,
                                 plan_: Optional[Tuple[int, int, int]] = None
                                 ) -> torch.Tensor:
    """K6's arithmetic in torch ops, under `plan_` (plan's by default): its
    K splits, each split's four warp ranges, the merge order and the bf16
    rounding of nibble * scale for grouped scales. The kernel sums each
    range in another order (the tensor cores'), so the two agree to the
    fp32 rounding of the sums and the bf16 rounding of the output."""
    w, s = p["kernel_q4p"], p["kernel_scale4p"]
    b, k = x.shape
    if plan_ is None:
        plan_ = plan(b, k, w.shape[1], s.shape[1])
    _, splits, ksplit = plan_
    return _w4_split_plain(x, w, s, row_ranges(k, splits, ksplit // K_TILE))


def w4_dense_stacked(x: torch.Tensor, p: Params,
                     plan_: Optional[Tuple[int, int, int]] = None
                     ) -> torch.Tensor:
    """y (B, N) = x (B, K) @ dequant(layer slice p): K6 for CUDA tensors
    (bf16 x, written straight into (B, N)), the plain version for CPU
    tensors. `plan_` replaces plan's (for tests and measurement)."""
    w, s = p["kernel_q4p"], p["kernel_scale4p"]
    if x.device.type == "cpu":
        return w4_dense_stacked_plain(x, p)
    if any(not t.is_cuda or t.device != x.device for t in (x, w, s)):
        raise ValueError("w4_dense_stacked: all inputs on one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 or (
            s.dtype != torch.bfloat16):
        raise TypeError("w4_dense_stacked: x bf16, kernel_q4p int8, "
                        "kernel_scale4p bf16")
    b, k = x.shape
    np_ = w.shape[1]
    ng = s.shape[1]
    if (
        x.ndim != 2 or w.shape != (k, np_) or s.shape != (2, ng, np_)
        or ng < 1 or k % ng or np_ % 8 or b < 1
    ):
        raise ValueError(
            f"w4_dense_stacked: unsupported shapes x {tuple(x.shape)} "
            f"kernel_q4p {tuple(w.shape)} kernel_scale4p {tuple(s.shape)} "
            "(needs K % G == 0 and N/2 % 8 == 0)"
        )
    if any(not t.is_contiguous() for t in (x, w, s)) or any(
            t.data_ptr() % 16 for t in (x, w, s)):
        raise ValueError("w4_dense_stacked: inputs must be contiguous and "
                         "16-byte aligned")
    rc, splits, ksplit = plan(b, k, np_, ng) if plan_ is None else plan_
    tiles = _cdiv(np_, TILE_NP) * _cdiv(b, rc)
    if tiles > _kernels.MAX_TICKETS:
        raise ValueError(f"w4_dense_stacked: {tiles} tiles exceed "
                         f"{_kernels.MAX_TICKETS}")
    if k % 8:  # the kernel's 16-byte copies of x want rows of 8 elements
        x = torch.nn.functional.pad(x, (0, 8 - k % 8))
    y = torch.empty((b, 2 * np_), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits if splits > 1 else 0, b, 2 * np_),
                          dtype=torch.float32, device=x.device)
    counters = _kernels.tickets(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_w4_gemv(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
            partial.data_ptr(), counters.data_ptr(),
            b, k, np_, ng, rc, splits, ksplit, stream,
        )
    _kernels.check(err, KERNEL)
    _kernels.launches[KERNEL] += 1
    return y


def w4_gemm_plain(x: torch.Tensor, kernel_q4p: torch.Tensor,
                  kernel_scale4p: torch.Tensor) -> torch.Tensor:
    """y (..., N) = x (..., K) @ dequant(W): w4_dense_stacked_plain's
    arithmetic for any leading dims."""
    k = x.shape[-1]
    w = plain_weights(kernel_q4p, kernel_scale4p, x.dtype)
    y = (x.reshape(-1, k).float() @ w).to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def w4_gemm_split_plain(x: torch.Tensor, kernel_q4p: torch.Tensor,
                        kernel_scale4p: torch.Tensor,
                        plan_: Optional[GemmPlan] = None) -> torch.Tensor:
    """K7's arithmetic on the decode-row loop (a "mma" plan: up to 32 rows
    and the TMA stride rule's shapes), in torch ops: K6's
    (`w4_dense_stacked_split_plain`) under gemm_plan's K splits, for any
    leading dims. `plan_` replaces gemm_plan's."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    np_ = kernel_q4p.shape[-1]
    if plan_ is None:
        plan_ = gemm_plan(x2.shape[0], k, 2 * np_, np_)
    if plan_.path != "mma":
        raise ValueError(f"w4_gemm_split_plain: a 'mma' plan, got {plan_}")
    ranges = row_ranges(k, plan_.splits, plan_.tps * TILE_K // K_TILE)
    y = _w4_split_plain(x2, kernel_q4p, kernel_scale4p, ranges)
    return y.reshape(*x.shape[:-1], 2 * np_)


def _w4_gemm_forward(x, w, s):
    if x.device.type == "cpu":
        return w4_gemm_plain(x, w, s)
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    np_, ng = w.shape[-1], s.shape[1] if s.ndim == 3 else 0
    if (
        w.ndim != 2 or w.shape[0] != k or s.shape != (2, ng, np_)
        or x2.shape[0] < 1 or not w4_gemm_takes(k, np_, ng)
    ):
        raise ValueError(
            f"w4_gemm: unsupported shapes x {tuple(x.shape)} kernel_q4p "
            f"{tuple(w.shape)} kernel_scale4p {tuple(s.shape)} (needs K % "
            f"{TILE_K} == 0, N/2 % 8 == 0, K % G == 0 and, for G > 1, "
            f"(K / G) % {TILE_K} == 0)")
    check_gemm_inputs(GEMM_KERNEL, x2, w, s)
    y = launch_dq_gemm(1, GEMM_KERNEL, x2, w, s, 2 * np_, ng)
    return y.reshape(*x.shape[:-1], 2 * np_)


class _W4Gemm(torch.autograd.Function):
    """The reference's custom VJP (halva_tpu/ops/w4_matmul.py:460-474):
    dx = g @ dequant(W, g.dtype).T, the dequantized weights made again for
    the backward instead of being kept; the packed weights and their scales
    get no gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q4p, kernel_scale4p):
        ctx.save_for_backward(kernel_q4p, kernel_scale4p)
        return _w4_gemm_forward(x, kernel_q4p, kernel_scale4p)

    @staticmethod
    def backward(ctx, g):
        w = dequantize_int4(*ctx.saved_tensors, g.dtype)
        return g @ w.t(), None, None


def w4_gemm(x: torch.Tensor, kernel_q4p: torch.Tensor,
            kernel_scale4p: torch.Tensor) -> torch.Tensor:
    """y (..., N) = x (..., K) @ dequant(kernel_q4p (K, N/2), kernel_scale4p
    (2, G, N/2)) in x's dtype, any number of rows: K7 for CUDA tensors (bf16
    x), the plain version for CPU tensors. Differentiable in x only."""
    return _W4Gemm.apply(x, kernel_q4p, kernel_scale4p)


def w4_gemm_takes(k: int, n_half: int, groups: int) -> bool:
    """Whether K7 takes weights of K rows, N/2 packed columns and G scale
    groups: its K tiles of TILE_K rows each lie in one scale group."""
    return (groups >= 1 and k % groups == 0 and k % TILE_K == 0
            and n_half % 8 == 0
            and (groups == 1 or (k // groups) % TILE_K == 0))


def w4_route(rows: int, k: int, n_half: int, groups: int) -> str:
    """The kernel of a decode-family packed-int4 matmul, from its shapes
    alone: "w4_gemm" (K7) above W4_GEMV_MAX_ROWS rows where K7 takes the
    weights, else "w4_gemv" (K6, which takes any K % G == 0)."""
    if rows > W4_GEMV_MAX_ROWS and w4_gemm_takes(k, n_half, groups):
        return GEMM_KERNEL
    return KERNEL


def w4_decode_matmul(x: torch.Tensor, p: Params) -> torch.Tensor:
    """A decode-family matmul y (B, N) = x (B, K) @ dequant(layer slice p)
    on the kernel `w4_route` names: K6 up to W4_GEMV_MAX_ROWS rows and for
    the scale groups K7 refuses, K7 above (the same function; on CPU
    tensors the same arithmetic)."""
    w, s = p["kernel_q4p"], p["kernel_scale4p"]
    route = w4_route(x.shape[0], w.shape[0], w.shape[-1], s.shape[1])
    if route == GEMM_KERNEL:
        return w4_gemm(x, w, s)
    return w4_dense_stacked(x, p)
