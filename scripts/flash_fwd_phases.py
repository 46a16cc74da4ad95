#!/usr/bin/env python3
"""Where a key tile of K1 (the flash-attention forward) spends its time.

    python3 scripts/flash_fwd_phases.py

Copies halva_tpu_torch/csrc/flash_fwd.cu and its header into
build/probe/flash_phases/, stamps the copy with clock64 at the phase
boundaries of a key tile and builds it with nvcc into its own library. In a
consumer warpgroup (thread 0 of each): waiting for the stage (full
mbarrier), S = Q K^T (issue and wait), the mask and softmax, O += P V
(issue and wait); in the producer warp (lane 0): waiting for a free stage
(empty mbarrier), and the rest of a tile (segment ids, their range, the
copies' issue). Each stamped thread sums its cycles per phase and adds them
to a device counter at its end. For the prefill shape (B=4, S=623, H=32,
padded rows), the train shape under ALiBi and window 256 (B=4, S=1087) and
one 4,608-token row (H=32, KVH=8, window 4096, and causal only) it prints
the launch's device time (CUDA events, median of 10; the stamps cost some)
and the mean cycles per tile of each phase. Needs a CUDA card and nvcc;
imports no JAX.
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
from halva_tpu_torch.ops.flash_attention import FWD_STAGES  # noqa: E402

CONSUMER = ("wait", "qk", "softmax", "pv")
PRODUCER = ("empty", "rest")
NSTAMPS = len(CONSUMER) + 1 + len(PRODUCER) + 1  # phases and tile counts

# (anchor in flash_fwd.cu, text put before it, text put after it)
EDITS = [
    ("namespace {\n\nusing halva::mbar_arrive;",
     "__device__ unsigned long long halva_stamps[%d];\n" % NSTAMPS, ""),
    ("    const int* ks = kvseg + (long)b * Skv;",
     "    unsigned long long pt[2] = {0, 0}, pn = 0;\n", ""),
    ("      if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);",
     "      const long long p0_ = clock64();\n",
     "\n      const long long p1_ = clock64();\n"
     "      pt[0] += p1_ - p0_;\n"),
    ("      } else {\n        mbar_arrive(fb);\n      }\n",
     "", "      pt[1] += clock64() - p1_;\n      ++pn;\n"),
    ("    return;\n  }\n\n  asm volatile(\"setmaxnreg.inc",
     "    if (lane == 0) {\n"
     "      atomicAdd(&halva_stamps[%d], pt[0]);\n"
     "      atomicAdd(&halva_stamps[%d], pt[1]);\n"
     "      atomicAdd(&halva_stamps[%d], pn);\n"
     "    }\n" % (len(CONSUMER) + 1, len(CONSUMER) + 2, len(CONSUMER) + 3),
     ""),
    ("  for (int i = 0; i < n; ++i) {\n    const int st = i % STAGES;\n"
     "    const int c0 = (t_lo + i) * BK;\n    mbar_wait(full",
     "  unsigned long long ct[4] = {0, 0, 0, 0}, cn = 0;\n", ""),
    ("    mbar_wait(full + 8 * st, (i / STAGES) & 1);",
     "    long long c0_ = clock64();\n", "\n    long long c1_ = clock64();\n"
     "    ct[0] += c1_ - c0_;\n"),
    ("      // the softmax of this tile, P in s",
     "      long long c2_ = clock64();\n      ct[1] += c2_ - c1_;\n", ""),
    ("      uint32_t pa[BK / 16][4], pl[BK / 16][4];",
     "      long long c3_ = clock64();\n      ct[2] += c3_ - c2_;\n", ""),
    ("    }\n    // this warp's reads of the stage are done",
     "      ct[3] += clock64() - c3_;\n      ++cn;\n", ""),
    ("  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;",
     "  if ((threadIdx.x & 127) == 0) {\n"
     "    for (int k = 0; k < 4; ++k) atomicAdd(&halva_stamps[k], ct[k]);\n"
     "    atomicAdd(&halva_stamps[4], cn);\n  }\n", ""),
]

TAIL = """
extern "C" int halva_flash_stamps(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[%d] = {};
    return (int)cudaMemcpyToSymbol(halva_stamps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, halva_stamps,
                                   sizeof(unsigned long long) * %d);
}
""" % (NSTAMPS, NSTAMPS)


def stamped_source() -> str:
    with open(os.path.join(_kernels.CSRC, "flash_fwd.cu")) as f:
        src = f.read()
    for anchor, before, after in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"flash_fwd_phases: anchor not found once: "
                             f"{anchor[:60]!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + TAIL


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "probe", "flash_phases")
    os.makedirs(out, exist_ok=True)
    for header in ("hopper_common.cuh", "flash_common.cuh"):
        shutil.copy(os.path.join(_kernels.CSRC, header), out)
    src = os.path.join(out, "flash_fwd.cu")
    with open(src, "w") as f:
        f.write(stamped_source())
    lib = os.path.join(out, "libflash_phases.so")
    r = subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS,
                        "-shared", "-o", lib, src], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"flash_fwd_phases: nvcc failed:\n{r.stderr}")
    cdll = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.halva_flash_fwd_bf16.argtypes = [p] * 7 + [i] * 6 + [f] + [i] * 5 + [p]
    cdll.halva_flash_fwd_bf16.restype = i
    cdll.halva_flash_stamps.argtypes = [p, i]
    cdll.halva_flash_stamps.restype = i
    return cdll


def run(cdll, label, b, s, h, kvh, lens, gen, window=0, alibi=0,
        bk=64):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v = r(b, s, h, 128), r(b, s, kvh, 128), r(b, s, kvh, 128)
    pos = torch.arange(s, device="cuda")[None]
    seg = (pos < torch.tensor(lens, device="cuda")[:, None]).int()
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = cdll.halva_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            seg.data_ptr(), o.data_ptr(), lse.data_ptr(), b, s, s, h, kvh,
            128, 128**-0.5, 1, alibi, window, 0, bk, stream)
        if err:
            raise RuntimeError(f"stamped flash_fwd: CUDA error {err}")

    launch()
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
    cdll.halva_flash_stamps(None, 1)
    launch()
    torch.cuda.synchronize()
    got = (ctypes.c_ulonglong * NSTAMPS)()
    cdll.halva_flash_stamps(ctypes.cast(got, ctypes.c_void_p), 0)
    c = list(got)
    nc, npr = max(c[len(CONSUMER)], 1), max(c[-1], 1)
    cons = ", ".join(f"{n} {c[i] / nc:.0f}" for i, n in enumerate(CONSUMER))
    prod = ", ".join(f"{n} {c[len(CONSUMER) + 1 + i] / npr:.0f}"
                     for i, n in enumerate(PRODUCER))
    print(f"{label} bk={bk}: {statistics.median(times):.4f} ms stamped; "
          f"cycles per tile: consumer warpgroup {cons} ({nc} tiles); "
          f"producer {prod} ({npr} tiles)", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_phases: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    cdll = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = 1087
    for bk in sorted(FWD_STAGES):
        run(cdll, "prefill B=4 S=623", 4, 623, 32, 32, (623, 615, 608, 623),
            gen, bk=bk)
        run(cdll, "train B=4 S=1087 alibi", 4, t, 32, 32,
            (t, t - 7, t - 64, t - 301), gen, alibi=1, bk=bk)
        run(cdll, "train B=4 S=1087 window 256", 4, t, 32, 32,
            (t, t - 7, t - 64, t - 301), gen, window=256, bk=bk)
        run(cdll, "one 4,608-token row, window 4096", 1, 4608, 32, 8,
            (4608,), gen, window=4096, bk=bk)
        run(cdll, "one 4,608-token row, causal", 1, 4608, 32, 8, (4608,),
            gen, bk=bk)


if __name__ == "__main__":
    main()
