"""Weight-only int8 matmul, y = (x @ q) * scale: K8 (CUDA, csrc/dq_gemm.cu)
and its plain version.

Counterpart of halva_tpu/ops/int8_matmul.py. x (..., K), q (K, N) int8,
scale (1, N) or (N,); leading dims of x are flattened for the product and
restored. The kernel dequantizes weight tiles in shared memory, so device
memory sees only the int8 bytes; `x @ (q * scale)` writes and re-reads a
bf16 copy of the weights on every call.

`int8_matmul` launches K8 for CUDA tensors (bf16 x and scale) and uses
`int8_matmul_plain` for CPU tensors; on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from halva_tpu_torch import _kernels

KERNEL = "int8_matmul"

# the tiled loop of csrc/dq_gemm.cu, shared with K7 (ops/w4_matmul.w4_gemm)
TILE_K = 64
SMALL_M = 32  # rows up to which the 32-row tile runs, else the 128-row one
TILES = {32: 256, 128: 128}  # row tile -> output channels per block
TARGET_BLOCKS = 264  # two blocks per SM of an H100's 132
MIN_TILES_PER_SPLIT = 4
MAX_SPLITS = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """Launch plan of the dequantizing GEMM: (row tile, K splits, K tiles
    per split). While the row and column tiles alone leave SMs idle, K is
    split until the grid holds about two blocks per SM, each split at least
    MIN_TILES_PER_SPLIT K tiles and none empty. The splits' fp32 partial
    tiles are summed in split order by the last block to finish
    (csrc/dq_gemm.cu)."""
    bm = 32 if m <= SMALL_M else 128
    tiles = _cdiv(m, bm) * _cdiv(n, TILES[bm])
    kt = k // TILE_K
    splits = max(1, min(TARGET_BLOCKS // tiles, kt // MIN_TILES_PER_SPLIT,
                        MAX_SPLITS))
    tps = _cdiv(kt, splits)
    return bm, _cdiv(kt, tps), tps


def launch_dq_gemm(mode: int, name: str, x2: torch.Tensor, w: torch.Tensor,
                   s: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """One launch of csrc/dq_gemm.cu on checked 2-D inputs: mode 0 = K8,
    1 = K7. Counts the launch under `name`."""
    m, k = x2.shape
    bm, splits, tps = gemm_plan(m, k, n)
    tiles = _cdiv(m, bm) * _cdiv(n, TILES[bm])
    if splits > 1 and tiles > _kernels.MAX_TICKETS:
        raise ValueError(f"{name}: {tiles} tiles exceed "
                         f"{_kernels.MAX_TICKETS}")
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    partial = torch.empty((splits if splits > 1 else 0, m, n),
                          dtype=torch.float32, device=x2.device)
    tickets = _kernels.tickets(x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().halva_dq_gemm(
            mode, x2.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), m, k, n, groups, bm,
            splits, tps, stream,
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
