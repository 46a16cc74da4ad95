"""Weight-only int8 matmul, y = (x @ q) * scale: K8 (CUDA, csrc/dq_gemm.cu)
and its plain version.

Counterpart of halva_tpu/ops/int8_matmul.py. x (..., K), q (K, N) int8,
scale (1, N) or (N,); leading dims of x are flattened for the product and
restored. The kernel dequantizes weight tiles on chip, so device memory
sees only the int8 bytes; `x @ (q * scale)` writes and re-reads a
bf16 copy of the weights on every call.

`int8_matmul` launches K8 for CUDA tensors (bf16 x and scale) and uses
`int8_matmul_plain` for CPU tensors; on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from halva_tpu_torch import _kernels

KERNEL = "int8_matmul"

# the launch plan of csrc/dq_gemm.cu, shared with K7 (ops/w4_matmul.w4_gemm)
TILE_K = 64
TILE_N = 256  # output channels per block on the wgmma path
SMALL_M = 32  # rows up to which the decode-row loop (csrc/dq_rows.cuh) runs
ROW_CHUNKS = (8, 16, 32)  # its row tiles: one to four n8 tiles of mma.sync
ROWS_TILE_BYTES = 64  # its column tile: weight bytes a row per block
ROWS_TILE_K = 32  # its K tile; each warp of a block takes a share of a
ROWS_WARPS = 4  # split's, in order
WGMMA_M = 128  # row tile of the TMA + wgmma path above SMALL_M
TMA_STRIDE = 16  # bytes: TMA wants every global row stride a multiple of it
SM_COUNT = 132  # an H100's SMs: one block each on the wgmma path
# blocks an SM the decode-row loop's plans aim at; the kernel holds up to
# four (csrc/dq_rows.cuh, Shape::BLOCKS), but fewer, longer warps measured
# faster (NVIDIA H100 80GB HBM3; chip_smoke.py --gemm-only, "gemm plans")
ROWS_BLOCKS_PER_SM = 2
# a split plan's partial tiles and last-block merge, in a warp's K-tile times
# a split (csrc/dq_rows.cuh stamped: scripts/w4_gemv_phases.py)
SPLIT_MERGE_TILES = 1.5
WAVE_TILES = 3  # a wave's start (its first copies) and its epilogue
MIN_TILES_PER_SPLIT = 4
MAX_SPLITS = 16
# a split's cost on the wgmma path: its fp32 partials (m x n x 4 bytes) are
# written and read back at about PARTIAL_BYTES_PER_S, while a block takes
# about KTILE_S per K tile (NVIDIA H100 80GB HBM3; chip_smoke.py --gemm-only)
PARTIAL_BYTES_PER_S = 2.5e12
KTILE_S = 1.1e-6


class GemmPlan(NamedTuple):
    path: str  # "mma" (the decode-row loop, mma.sync) or "wgmma" (TMA)
    bm: int  # row tile: 8, 16 or 32 on "mma", 128 on "wgmma"
    splits: int  # K splits
    tps: int  # K tiles per split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(kt: int, splits: int) -> Tuple[int, int]:
    """(splits, tps) with splits * tps covering kt K tiles, none empty."""
    tps = _cdiv(kt, splits)
    return _cdiv(kt, tps), tps


def row_chunk(m: int) -> int:
    """The decode-row loop's row tile for m rows: the least of ROW_CHUNKS
    that holds them, 32-row chunks above."""
    return next(c for c in ROW_CHUNKS if c >= min(m, SMALL_M))


def row_ranges(k: int, splits: int, tiles_per_split: int
               ) -> List[List[Tuple[int, int]]]:
    """The K rows each warp of the decode-row loop sums, split by split:
    [[(first, end) of warp w for w in 0..ROWS_WARPS-1] for each split]. A split
    owns `tiles_per_split` tiles of ROWS_TILE_K rows (the last split what is
    left); warp w takes the w-th share of them, rounded up, so a warp's
    range may be empty. Every row below k lies in exactly one range."""
    kt = _cdiv(k, ROWS_TILE_K)
    out = []
    for z in range(splits):
        t0 = z * tiles_per_split
        n = min(kt, t0 + tiles_per_split) - t0
        q = _cdiv(n, ROWS_WARPS)
        out.append([(min(k, (t0 + min(n, w * q)) * ROWS_TILE_K),
                     min(k, (t0 + min(n, (w + 1) * q)) * ROWS_TILE_K))
                    for w in range(ROWS_WARPS)])
    return out


def rows_splits(blocks: int, tiles: int, granule: int, most: int,
                sms: int = SM_COUNT) -> Tuple[int, int]:
    """(splits, tiles per split) of the decode-row loop for `blocks` output
    tiles and `tiles` K tiles of `granule` 32-row tiles each: the count up
    to `most` that finishes first, in a warp's K-tile times: the waves of
    ROWS_BLOCKS_PER_SM blocks an SM times a warp's share of a split and
    WAVE_TILES, plus SPLIT_MERGE_TILES a split for the merge of a split
    plan; the fewer splits on a tie. No split is empty."""
    best = None
    for want in range(1, most + 1):
        tps = _cdiv(tiles, want)
        splits = _cdiv(tiles, tps)
        cost = (_cdiv(blocks * splits, ROWS_BLOCKS_PER_SM * sms)
                * (_cdiv(tps * granule, ROWS_WARPS) + WAVE_TILES)
                + (SPLIT_MERGE_TILES * splits if splits > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, splits, tps)
    return best[1], best[2]


def split_sum_plain(x2: torch.Tensor, w: torch.Tensor,
                    ranges: List[List[Tuple[int, int]]]) -> torch.Tensor:
    """x2 (m, k) @ w (k, n) in fp32 in the decode-row loop's order: each
    warp's range a product, the warps of a split summed in warp order, the
    splits in split order."""
    xf, wf = x2.float(), w.float()
    total = None
    for split in ranges:
        part = None
        for b, e in split:
            d = xf[:, b:e] @ wf[b:e]
            part = d if part is None else part + d
        total = part if total is None else total + part
    return total


def gemm_plan(m: int, k: int, n: int, row_bytes: int) -> GemmPlan:
    """Launch plan of the dequantizing GEMM for x (m, k) and n output
    channels whose weight rows are `row_bytes` long (n for K8, n/2 for K7).

    Up to SMALL_M rows the decode-row loop (csrc/dq_rows.cuh): row tiles of
    8, 16 or 32 (`row_chunk`), column tiles of ROWS_TILE_BYTES weight bytes,
    K split by `rows_splits`. Above SMALL_M rows the TMA + wgmma path (128 x
    256 tiles, one block per SM), unless the weight rows are not a multiple
    of TMA_STRIDE bytes: those go to the decode-row loop in 32-row chunks.
    Each split is at least MIN_TILES_PER_SPLIT K tiles and none is empty; on
    the wgmma path the split count is the one that finishes first, in K-tile
    times: a block's K tiles per wave of SM_COUNT blocks, plus the traffic
    of the partials. The splits' fp32 partial tiles are summed in split
    order by the last block to finish."""
    kt = k // TILE_K
    most = max(1, min(kt // MIN_TILES_PER_SPLIT, MAX_SPLITS))
    if m <= SMALL_M or row_bytes % TMA_STRIDE:
        bm = row_chunk(m)
        tiles = _cdiv(m, bm) * _cdiv(row_bytes, ROWS_TILE_BYTES)
        return GemmPlan("mma", bm, *rows_splits(
            tiles, kt, TILE_K // ROWS_TILE_K, most))
    tiles = _cdiv(m, WGMMA_M) * _cdiv(n, TILE_N)
    best, best_cost = (1, kt), _cdiv(tiles, SM_COUNT) * kt
    if tiles < SM_COUNT:
        per_split = m * n * 8 / (PARTIAL_BYTES_PER_S * KTILE_S)
        for want in range(2, most + 1):
            splits, tps = split_k(kt, want)
            cost = (_cdiv(tiles * splits, SM_COUNT) * tps
                    + per_split * splits)
            if cost < best_cost:
                best, best_cost = (splits, tps), cost
    return GemmPlan("wgmma", WGMMA_M, *best)


def plan_tiles(plan: GemmPlan, m: int, n: int, row_bytes: int) -> int:
    """The output tiles of a launch under `plan`: its split tickets."""
    if plan.path == "mma":
        return _cdiv(m, plan.bm) * _cdiv(row_bytes, ROWS_TILE_BYTES)
    return _cdiv(m, plan.bm) * _cdiv(n, TILE_N)


def launch_dq_gemm(mode: int, name: str, x2: torch.Tensor, w: torch.Tensor,
                   s: torch.Tensor, n: int, groups: int,
                   plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """One launch of csrc/dq_gemm.cu on checked 2-D inputs: mode 0 = K8,
    1 = K7. Counts the launch under `name`. `plan` replaces gemm_plan's (for
    measuring other plans)."""
    m, k = x2.shape
    if plan is None:
        plan = gemm_plan(m, k, n, w.shape[-1])
    tiles = plan_tiles(plan, m, n, w.shape[-1])
    if plan.splits > 1 and tiles > _kernels.MAX_TICKETS:
        raise ValueError(f"{name}: {tiles} tiles exceed "
                         f"{_kernels.MAX_TICKETS}")
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    partial = torch.empty((plan.splits if plan.splits > 1 else 0, m, n),
                          dtype=torch.float32, device=x2.device)
    tickets = _kernels.tickets(x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_dq_gemm(
            mode, x2.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), m, k, n, groups, plan.bm,
            plan.splits, plan.tps, stream,
        )
    _kernels.check(err, name)
    _kernels.launches[name] += 1
    return y


def check_gemm_inputs(name: str, x: torch.Tensor, w: torch.Tensor,
                      s: torch.Tensor) -> None:
    """What both kernels of csrc/dq_gemm.cu ask of their tensors."""
    if any(not t.is_cuda or t.device != x.device for t in (x, w, s)):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 or (
            s.dtype != torch.bfloat16):
        raise TypeError(f"{name}: x bf16, weights int8, scales bf16 (got "
                        f"{x.dtype}, {w.dtype}, {s.dtype})")
    if any(not t.is_contiguous() for t in (x, w, s)) or any(
            t.data_ptr() % 16 for t in (x, w, s)):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned")


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """(x @ q in fp32) * scale, cast to x's dtype."""
    k = x.shape[-1]
    y = (x.reshape(-1, k).float() @ q.float()) * scale.reshape(1, -1).float()
    return y.to(x.dtype).reshape(*x.shape[:-1], q.shape[-1])


def int8_matmul_split_plain(x: torch.Tensor, q: torch.Tensor,
                            scale: torch.Tensor,
                            plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """K8's arithmetic on the decode-row loop (a "mma" plan: up to 32 rows
    and the TMA stride rule's shapes), in torch ops: int8 weights (exact in
    bf16) times x in fp32, summed in the loop's K ranges and merge order
    (`row_ranges`, `split_sum_plain`), the fp32 sum times the channel scale,
    cast to x's dtype. `plan` replaces gemm_plan's."""
    k, n = q.shape
    x2 = x.reshape(-1, k)
    if plan is None:
        plan = gemm_plan(x2.shape[0], k, n, n)
    if plan.path != "mma":
        raise ValueError(f"int8_matmul_split_plain: a 'mma' plan, got {plan}")
    ranges = row_ranges(k, plan.splits, plan.tps * TILE_K // ROWS_TILE_K)
    y = split_sum_plain(x2, q, ranges) * scale.reshape(1, -1).float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


def int8_matmul_takes(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> bool:
    """Whether K8 takes these operands, from their shapes and dtypes alone:
    bf16 x and scales, int8 q (K, N) with K % TILE_K == 0 and N % 8 == 0,
    at least one row."""
    if q.ndim != 2:
        return False
    k, n = q.shape
    return (x.dtype == torch.bfloat16 and q.dtype == torch.int8
            and scale.dtype == torch.bfloat16 and x.shape[-1] == k
            and scale.numel() == n and x.numel() >= k and k % TILE_K == 0
            and n % 8 == 0)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y (..., N) = (x (..., K) @ q (K, N) int8) * scale in x's dtype: K8
    for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    k = x.shape[-1]
    n = q.shape[-1]
    x2 = x.reshape(-1, k)
    s = scale.reshape(-1)
    if q.ndim != 2 or q.shape[0] != k or s.shape[0] != n or (
            x2.shape[0] < 1 or k % TILE_K or n % 8):
        raise ValueError(
            f"int8_matmul: unsupported shapes x {tuple(x.shape)} q "
            f"{tuple(q.shape)} scale {tuple(scale.shape)} (needs K % "
            f"{TILE_K} == 0 and N % 8 == 0)")
    check_gemm_inputs(KERNEL, x2, q, s)
    y = launch_dq_gemm(0, KERNEL, x2, q, s, n, 1)
    return y.reshape(*x.shape[:-1], n)
