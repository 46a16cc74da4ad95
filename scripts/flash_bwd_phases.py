#!/usr/bin/env python3
"""Where a tile of K2 and K3 (the flash-attention backward) spends its time.

    python3 scripts/flash_bwd_phases.py

Copies halva_tpu_torch/csrc/flash_bwd.cu and its headers into
build/probe/flash_bwd_phases/, stamps the copy with clock() at the phase
boundaries of a tile and builds it with nvcc into its own library. In a
consumer warpgroup (thread 0 of each; under K3's 64-key layout warpgroup 0
only): the block's start up to the walk (the id ranges, the wait for the
operands the block keeps), then per tile waiting for the stage (full
mbarrier), issuing S and dP and waiting for S, computing P, waiting for dP
and computing dS and its bf16 A fragments, the last products (K2: issuing
dQ += dS K, which runs on under the next tile; K3: dV += P^T dO and
dK += dS^T Q, issued and waited), and after the walk the epilogue's stores.
In the producer warp (lane 0): waiting for a free stage (empty mbarrier),
and its whole loop. Each stamped thread sums its cycles per phase and adds
them to a device counter at its end. At the train shape (B=4 rows of 1087
spliced tokens, padded, H=32) in the base, ALiBi and window-256 modes, at
Mistral's B=2 train rows (KVH=8) and on one 4,608-token row (H=32 over
KVH=8, window 4096 and causal) it prints each launch's device time (CUDA
events, median of 10; the stamps cost some) and the mean cycles of each
phase, per tile and per block, for K2 and for K3 under both of its
layouts. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from halva_tpu_torch import _kernels  # noqa: E402
from halva_tpu_torch.ops.flash_attention import (  # noqa: E402
    BWD_DKV_KEYS,
    BWD_TILE,
    flash_attention_delta,
    flash_attention_fwd,
)

TILE_PHASES = ("wait", "issue S, dP; wait S", "P", "wait dP; dS",
               "last products")
# per kernel: block start, the tile phases, epilogue, tiles, blocks; then
# the producer's empty waits, its loop, its tiles
CONSUMER = ("start",) + TILE_PHASES + ("epilogue", "tiles", "blocks")
PRODUCER = ("empty", "loop", "tiles")
PER_KERNEL = len(CONSUMER) + len(PRODUCER)
NSTAMPS = 2 * PER_KERNEL  # K2's, then K3's
K3_MARK = "// grid (KVH, B, key tiles), first key tile first."


def _flush(base: int) -> str:
    adds = "".join(
        f"      atomicAdd(&halva_stamps[{base + k}], "
        f"(unsigned long long)ct[{k}]);\n" for k in range(7))
    return ("  ct[6] = clock() - t_loop;\n"
            "  if ((threadIdx.x & 127) == 0) {\n" + adds +
            f"      atomicAdd(&halva_stamps[{base + 7}], "
            "(unsigned long long)cn);\n"
            f"      atomicAdd(&halva_stamps[{base + 8}], 1ull);\n  }}\n")


def _producer(base: int) -> str:
    b = base + len(CONSUMER)
    return ("    if (lane == 0) {\n"
            f"      atomicAdd(&halva_stamps[{b}], (unsigned long long)pt0);\n"
            f"      atomicAdd(&halva_stamps[{b + 1}], "
            "(unsigned long long)((unsigned)clock() - pstart));\n"
            f"      atomicAdd(&halva_stamps[{b + 2}], "
            "(unsigned long long)n);\n    }\n")


# (anchor, text put before it, text put after it), for K2's part of the
# source and for K3's
PRODUCER_WAIT = (
    "      if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);",
    "      const unsigned p0_ = clock();\n", "\n      pt0 += clock() - p0_;\n")
CONSUMER_START = ("      P::CONSUMER_REGS));\n", "",
                  "  const unsigned t_start = clock();\n"
                  "  unsigned ct[7] = {0, 0, 0, 0, 0, 0, 0}, cn = 0;\n")
FULL_WAIT = ("    mbar_wait(full + 8 * st, (i / STAGES) & 1);",
             "    const unsigned c0_ = clock();\n",
             "\n    const unsigned c1_ = clock();\n    ct[1] += c1_ - c0_;\n")
PRODUCER_END = "    return;\n  }\n\n  asm volatile(\"setmaxnreg.inc"
EDITS_K2 = [
    ("namespace {\n\nusing halva::mbar_arrive;",
     "__device__ unsigned long long halva_stamps[%d];\n" % NSTAMPS, ""),
    ("    for (int i = 0; i < n; ++i) {\n      const int st = i % STAGES;\n"
     "      const int c0 = (t_lo + i) * TILE;\n      int sv[TILE / 32];",
     "    unsigned pt0 = 0;\n    const unsigned pstart = clock();\n", ""),
    PRODUCER_WAIT,
    (PRODUCER_END, _producer(0), ""),
    CONSUMER_START,
    ("  int held = -1;\n", "  ct[0] = clock() - t_start;\n", ""),
    FULL_WAIT,
    ("      if (kind == MASKED)\n        alibi ? dq_probs",
     "      const unsigned c2_ = clock();\n      ct[2] += c2_ - c1_;\n", ""),
    ("      halva::wgmma_wait<0>();\n      // dS = P",
     "      const unsigned c3_ = clock();\n      ct[3] += c3_ - c2_;\n", ""),
    ("      halva::wgmma_fence();\n      product_rs(acc",
     "      const unsigned c4_ = clock();\n      ct[4] += c4_ - c3_;\n", ""),
    ("      held = st;\n", "", "      ct[5] += clock() - c4_;\n      ++cn;\n"),
    ("  // dQ through this warpgroup's rows of the Q tile",
     "  const unsigned t_loop = clock();\n", ""),
    ("             row_base, Sq);\n", "", _flush(0)),
]
EDITS_K3 = [
    ("    for (int i = 0; i < n; ++i) {\n      const int st = i % STAGES;\n"
     "      const int h = kvh * G + i / per_head;",
     "    unsigned pt0 = 0;\n    const unsigned pstart = clock();\n", ""),
    PRODUCER_WAIT,
    (PRODUCER_END, _producer(PER_KERNEL), ""),
    CONSUMER_START,
    ("  for (int i = P::SPLIT ? wg : 0;", "  ct[0] = clock() - t_start;\n",
     ""),
    FULL_WAIT,
    ("      if (kind == MASKED)\n        alibi ? dkv_probs",
     "      const unsigned c2_ = clock();\n      ct[2] += c2_ - c1_;\n", ""),
    ("      halva::wgmma_wait<0>();\n      // dS^T",
     "      const unsigned c3_ = clock();\n      ct[3] += c3_ - c2_;\n", ""),
    ("      halva::wgmma_fence();\n      product_rs(dva",
     "      const unsigned c4_ = clock();\n      ct[4] += c4_ - c3_;\n", ""),
    ("    }\n    // this warp's reads of the stage are done",
     "      ct[5] += clock() - c4_;\n      ++cn;\n", ""),
    ("  if (P::SPLIT) {\n", "  const unsigned t_loop = clock();\n", ""),
    ("  write_rows(vbuf, P::K_HALF, dv + kv_off, kv_row, c0, Skv);\n", "",
     _flush(PER_KERNEL)),
]

TAIL = """
extern "C" int halva_flash_bwd_stamps(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[%d] = {};
    return (int)cudaMemcpyToSymbol(halva_stamps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, halva_stamps,
                                   sizeof(unsigned long long) * %d);
}
""" % (NSTAMPS, NSTAMPS)


def _apply(src: str, edits) -> str:
    for anchor, before, after in edits:
        if src.count(anchor) != 1:
            raise SystemExit(f"flash_bwd_phases: anchor not found once: "
                             f"{anchor[:60]!r}")
        src = src.replace(anchor, before + anchor + after)
    return src


def stamped_source() -> str:
    with open(os.path.join(_kernels.CSRC, "flash_bwd.cu")) as f:
        src = f.read()
    cut = src.index(K3_MARK)
    return (_apply(src[:cut], EDITS_K2) + _apply(src[cut:], EDITS_K3)
            + TAIL)


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "probe", "flash_bwd_phases")
    os.makedirs(out, exist_ok=True)
    for header in ("hopper_common.cuh", "flash_common.cuh"):
        shutil.copy(os.path.join(_kernels.CSRC, header), out)
    src = os.path.join(out, "flash_bwd.cu")
    with open(src, "w") as f:
        f.write(stamped_source())
    lib = os.path.join(out, "libflash_bwd_phases.so")
    r = subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS,
                        "-shared", "-o", lib, src], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"flash_bwd_phases: nvcc failed:\n{r.stderr}")
    for ln in (r.stdout + r.stderr).splitlines():
        if "spill" in ln and " 0 bytes spill stores" not in ln:
            print(f"  ptxas (stamped copy): {ln.strip()}")
    cdll = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.halva_flash_bwd_dq_bf16.argtypes = (
        [p] * 9 + [i] * 6 + [f] + [i] * 5 + [p])
    cdll.halva_flash_bwd_dkv_bf16.argtypes = (
        [p] * 10 + [i] * 6 + [f] + [i] * 5 + [p])
    cdll.halva_flash_bwd_stamps.argtypes = [p, i]
    return cdll


def run(cdll, label, b, s, h, kvh, lens, gen, window=0, alibi=0):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, do = r(b, s, h, 128), r(b, s, kvh, 128), r(b, s, kvh, 128), r(
        b, s, h, 128)
    pos = torch.arange(s, device="cuda")[None]
    seg = (pos < torch.tensor(lens, device="cuda")[:, None]).int()
    do[seg == 0] = 0
    o, lse = flash_attention_fwd(q, k, v, seg, seg, alibi=bool(alibi),
                                 sliding_window=window or None)
    delta = flash_attention_delta(o, do)
    ptrs = [t.data_ptr() for t in (q, k, v, seg, seg, do, lse, delta)]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    dims = (b, s, s, h, kvh, 128, 128**-0.5, 1, alibi, window, 0)
    launches = {
        "K2": (0, lambda: cdll.halva_flash_bwd_dq_bf16(
            *ptrs, dq.data_ptr(), *dims, BWD_TILE, stream))}
    for keys in BWD_DKV_KEYS:
        launches[f"K3 {keys} keys"] = (PER_KERNEL, (
            lambda keys=keys: cdll.halva_flash_bwd_dkv_bf16(
                *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, keys, stream)))
    for name, (base, launch) in launches.items():
        if launch():
            raise RuntimeError(f"stamped {name}: CUDA error")
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        cdll.halva_flash_bwd_stamps(None, 1)
        launch()
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * NSTAMPS)()
        cdll.halva_flash_bwd_stamps(ctypes.cast(got, ctypes.c_void_p), 0)
        c = list(got)[base:base + PER_KERNEL]
        tiles, blocks = max(c[7], 1), max(c[8], 1)
        ptiles = max(c[-1], 1)
        per_tile = ", ".join(f"{n} {c[1 + i] / tiles:.0f}"
                             for i, n in enumerate(TILE_PHASES))
        print(f"{label}, {name}: {statistics.median(times):.4f} ms stamped; "
              f"per warpgroup and block: start {c[0] / blocks:.0f}, "
              f"{tiles / blocks:.1f} tiles, epilogue {c[6] / blocks:.0f} "
              f"cycles; per tile: {per_tile}; producer per tile: empty "
              f"{c[9] / ptiles:.0f}, loop {c[10] / ptiles:.0f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_phases: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    cdll = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = 1087
    lens = (t, t - 7, t - 64, t - 301)
    run(cdll, "train B=4 S=1087", 4, t, 32, 32, lens, gen)
    run(cdll, "train B=4 S=1087 alibi", 4, t, 32, 32, lens, gen, alibi=1)
    run(cdll, "train B=4 S=1087 window 256", 4, t, 32, 32, lens, gen,
        window=256)
    run(cdll, "Mistral train B=2 S=1087 KVH=8 window 4096", 2, t, 32, 8,
        lens[:2], gen, window=4096)
    run(cdll, "one 4,608-token row, window 4096", 1, 4608, 32, 8, (4608,),
        gen, window=4096)
    run(cdll, "one 4,608-token row, causal", 1, 4608, 32, 8, (4608,), gen)


if __name__ == "__main__":
    main()
