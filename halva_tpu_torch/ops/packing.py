"""Sequence packing: several short samples per row, kept apart by segment ids.

Counterpart of halva_tpu/ops/packing.py. Packing is a host plan (greedy
first-fit-decreasing) plus one gather on the device; the flash kernels take
the plan's segment ids as they are, and positions restart at 0 per document
so that RoPE is per document. Token-count conservation is asserted.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class PackPlan(NamedTuple):
    src_row: np.ndarray  # (R, L) source row per output slot
    src_idx: np.ndarray  # (R, L) source position per output slot
    segment_ids: np.ndarray  # (R, L) 1-based per-document segment ids
    positions: np.ndarray  # (R, L) per-document positions
    doc_map: List[List[int]]  # output row -> original sample indices


def plan_packing(lengths: Sequence[int], max_len: int) -> PackPlan:
    """First-fit-decreasing bin packing of samples into rows of max_len."""
    lengths = np.asarray(lengths, np.int64)
    assert (lengths <= max_len).all(), "a sample exceeds the pack length"
    order = np.argsort(-lengths)
    bins: List[List[int]] = []
    space: List[int] = []
    for i in order:
        li = int(lengths[i])
        for b in range(len(bins)):
            if space[b] >= li:
                bins[b].append(int(i))
                space[b] -= li
                break
        else:
            bins.append([int(i)])
            space.append(max_len - li)

    r = len(bins)
    src_row = np.zeros((r, max_len), np.int32)
    src_idx = np.zeros((r, max_len), np.int32)
    seg = np.zeros((r, max_len), np.int32)
    pos = np.zeros((r, max_len), np.int32)
    for b, samples in enumerate(bins):
        cursor = 0
        for doc_id, s in enumerate(samples, start=1):
            li = int(lengths[s])
            sl = slice(cursor, cursor + li)
            src_row[b, sl] = s
            src_idx[b, sl] = np.arange(li)
            seg[b, sl] = doc_id
            pos[b, sl] = np.arange(li)
            cursor += li
    total = int(lengths.sum())
    assert int((seg != 0).sum()) == total, "packing lost tokens"
    return PackPlan(src_row, src_idx, seg, pos, bins)


def pack(plan: PackPlan, arrays: Dict[str, torch.Tensor],
         fill: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Gather (B, S, ...) tensors into packed (R, L, ...) rows, on the
    tensors' device. `fill` gives the pad value per key for slots with
    segment id 0."""
    out = {}
    for key, x in arrays.items():
        row = torch.as_tensor(plan.src_row, device=x.device).long()
        idx = torch.as_tensor(plan.src_idx, device=x.device).long()
        valid = torch.as_tensor(plan.segment_ids != 0, device=x.device)
        g = x[row, idx]
        mask = valid.reshape(valid.shape + (1,) * (g.ndim - valid.ndim))
        out[key] = torch.where(
            mask, g, torch.tensor(fill.get(key, 0), dtype=g.dtype,
                                  device=g.device))
    return out


def unpack_logps(packed: torch.Tensor,  # (R, L) values in packed layout
                 plan: PackPlan, batch: int, seq_len: int) -> torch.Tensor:
    """Scatter packed per-token values back to the (B, S) sample layout
    (fp32, on `packed`'s device)."""
    out = np.zeros((batch, seq_len), np.float32)
    vals = packed.detach().float().cpu().numpy()
    for r in range(plan.src_row.shape[0]):
        m = plan.segment_ids[r] != 0
        out[plan.src_row[r][m], plan.src_idx[r][m]] = vals[r][m]
    return torch.from_numpy(out).to(packed.device)


def pack_batch_np(
    samples: Sequence[Dict[str, np.ndarray]],
    keys: Sequence[str],
    max_len: int,
    fill: Dict[str, int],
) -> Tuple[Dict[str, np.ndarray], PackPlan]:
    """Host-side convenience: pack variable-length numpy samples."""
    lengths = [len(s[keys[0]]) for s in samples]
    plan = plan_packing(lengths, max_len)
    r = plan.src_row.shape[0]
    out = {
        k: np.full((r, max_len), fill.get(k, 0), samples[0][k].dtype)
        for k in keys
    }
    for row in range(r):
        m = plan.segment_ids[row] != 0
        src_rows = plan.src_row[row][m]
        src_idx = plan.src_idx[row][m]
        for k in keys:
            out[k][row][m] = np.array(
                [samples[sr][k][si] for sr, si in zip(src_rows, src_idx)])
    return out, plan
