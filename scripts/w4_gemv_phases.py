#!/usr/bin/env python3
"""Where a K tile of the decode-row loop (K6, and K7 / K8 up to 32 rows)
spends its time.

    python3 scripts/w4_gemv_phases.py

Copies halva_tpu_torch twice under build/probe/, stamps the loop of each
copy's csrc/dq_rows.cuh with clock64 at the phase boundaries of every K
tile of a warp (wait: cp.async.wait_group and __syncwarp; issue: the copies
of the tile STAGES - 1 ahead; compute: conversion and mma.sync), and with
globaltimer at the loop's ends, after the split's partials and its ticket,
and after the last block's merge. The second copy also replaces every
mma.sync by a cheap use of its operands, so that its compute phase is the
conversion alone: the product's cycles are the difference. Each copy runs
in a process of its own, which imports it; each case is launched once after
three warm-up launches, and the stamps of lane 0 of every warp are averaged.
Prints, per case, the plan, cycles per K tile by phase, and the mean
microseconds of the loop, of the epilogue up to the ticket and of the
merge. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# last: the stamped copy, on PYTHONPATH in the second process, comes first
sys.path.append(ROOT)

from halva_tpu_torch import _kernels  # noqa: E402

# (anchor in csrc/dq_rows.cuh, what the stamped copy puts in its place)
STAMPS = (
    ("namespace halva_rows {", """namespace halva_rows {
// one per source that includes the header: K6's, and K7's and K8's
static __device__ long long g_probe[1 << 18];
__device__ __forceinline__ long long pclk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ long long pgt() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}"""),
    ("""  for (int i = 0; i < n; ++i) {
    cp_wait<S::STAGES - 2>();  // this lane's copies of tile i
    __syncwarp();  // every lane's; and every lane is done with tile i - 1""",
     """  long long ph[3] = {0, 0, 0};
  const long long g0 = pgt();
  long long tp = pclk();
  for (int i = 0; i < n; ++i) {
    cp_wait<S::STAGES - 2>();  // this lane's copies of tile i
    __syncwarp();  // every lane's; and every lane is done with tile i - 1
    { long long t = pclk(); ph[0] += t - tp; tp = t; }"""),
    ("""    cp_commit();
    mma_stage<NT8, MODE>(a, ring + (i % S::STAGES) * S::STAGE,
                         (wb + i) * BK, c0, g, t, acc);
  }""", """    cp_commit();
    { long long t = pclk(); ph[1] += t - tp; tp = t; }
    mma_stage<NT8, MODE>(a, ring + (i % S::STAGES) * S::STAGE,
                         (wb + i) * BK, c0, g, t, acc);
    { long long t = pclk(); ph[2] += t - tp; tp = t; }
  }
  const long long g1 = pgt();
  const long pb = ((long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x) * S::NWARP + warp;
  const bool pw = lane == 0 && pb < (1 << 14);
  if (pw) {
    long long* o = g_probe + pb * 16;
    o[0] = ph[0]; o[1] = ph[1]; o[2] = ph[2]; o[3] = n;
    o[4] = g0; o[5] = g1; o[6] = 0; o[7] = 0;
  }"""),
    ("""      if (place(f, row, ch)) store(row, ch, gather(f));
    }
    return;""", """      if (place(f, row, ch)) store(row, ch, gather(f));
    }
    if (pw) g_probe[pb * 16 + 6] = pgt();
    return;"""),
    ("""  if (!is_last) return;""", """  if (pw) g_probe[pb * 16 + 6] = pgt();
  if (!is_last) return;"""),
    ("""  if (tid == 0) a.tickets[tile] = 0;
}""", """  if (tid == 0) a.tickets[tile] = 0;
  if (pw) g_probe[pb * 16 + 7] = pgt();
}"""),
)
# the conversion-only copy: every product becomes one use of its operands
NO_PRODUCT = (
    ("halva::mma_16816(acc[nt][mt][h], af, b[nt][0], b[nt][1]);",
     "acc[nt][mt][h][0] += __uint_as_float((af[0] ^ af[1] ^ af[2] ^ af[3] ^ "
     "b[nt][0] ^ b[nt][1]) & 0x007FFFFFu);"),
    ("halva::mma_16816(acc[nt][mt][0], af, b[nt][0], b[nt][1]);",
     "acc[nt][mt][0][0] += __uint_as_float((af[0] ^ af[1] ^ af[2] ^ af[3] ^ "
     "b[nt][0] ^ b[nt][1]) & 0x007FFFFFu);"),
)
# appended to w4_gemv.cu (suffix gemv: K6) and dq_gemm.cu (gemm: K7, K8)
READERS = """
extern "C" int halva_probe_read_{0}(void* host, long bytes) {{
  return (int)cudaMemcpyFromSymbol(host, halva_rows::g_probe, bytes);
}}
extern "C" int halva_probe_clear_{0}() {{
  static long long zeros[1 << 18];
  return (int)cudaMemcpyToSymbol(halva_rows::g_probe, zeros, sizeof(zeros));
}}
"""
# (what, K, N, rows, G): K6 at the smoke's batch, K7 at a beam step's rows
# and a verify step's, K8 at the int8 tree's decode rows (G = 0)
CASES = (
    ("K6 wq g=128", 4096, 4096, 4, 32),
    ("K6 gate/up g=128", 4096, 11008, 4, 32),
    ("K6 down g=128", 11008, 4096, 4, 86),
    ("K6 gate/up per channel", 4096, 11008, 4, 1),
    ("K7 gate/up g=128", 4096, 11008, 16, 32),
    ("K7 gate/up g=128", 4096, 11008, 32, 32),
    ("K8 gate/up", 4096, 11008, 4, 0),
)


def stamped_copy(name: str, product: bool) -> str:
    """halva_tpu_torch copied under build/probe/<name>/ with the stamps in
    its csrc/dq_rows.cuh (and, without `product`, no mma.sync); raises if
    an anchor is missing."""
    root = os.path.join(ROOT, "build", "probe", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "halva_tpu_torch"),
                    os.path.join(root, "halva_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "halva_tpu_torch", "csrc", "dq_rows.cuh")
    src = open(path).read()
    for anchor, stamped in STAMPS + (() if product else NO_PRODUCT):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:60]!r}")
        src = src.replace(anchor, stamped)
    open(path, "w").write(src)
    for source, suffix in (("w4_gemv.cu", "gemv"), ("dq_gemm.cu", "gemm")):
        with open(os.path.join(root, "halva_tpu_torch", "csrc", source),
                  "a") as f:
            f.write(READERS.format(suffix))
    return root


def run_stamped(what: str) -> None:
    """In a process that imported a stamped copy: each case once after
    three warm-up launches, its stamps averaged over warps."""
    import numpy as np

    from halva_tpu_torch.ops import int8_matmul as k8
    from halva_tpu_torch.ops import w4_matmul as w4

    if "probe" not in _kernels.__file__:
        raise RuntimeError(f"not a stamped copy: {_kernels.__file__}")
    cdll = _kernels.lib()
    for suffix in ("gemv", "gemm"):
        getattr(cdll, f"halva_probe_read_{suffix}").argtypes = [
            ctypes.c_void_p, ctypes.c_long]
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    for name, k, n, rows, groups in CASES:
        x = torch.randn(rows, k, generator=gen, device=dev).bfloat16()
        if groups == 0:
            q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            s = (torch.rand(n, generator=gen, device=dev) * 0.002).bfloat16()
            plan = k8.gemm_plan(rows, k, n, n)

            def launch():
                k8.int8_matmul(x, q, s)
        else:
            p = {"kernel_q4p": torch.randint(-128, 128, (k, n // 2),
                                             generator=gen, device=dev,
                                             dtype=torch.int8),
                 "kernel_scale4p": (torch.rand(2, groups, n // 2,
                                               generator=gen, device=dev)
                                    * 0.02).bfloat16()}
            if rows <= w4.W4_GEMV_MAX_ROWS:
                plan = w4.plan(rows, k, n // 2, groups)

                def launch():
                    w4.w4_dense_stacked(x, p)
            else:
                plan = k8.gemm_plan(rows, k, n, n // 2)

                def launch():
                    w4.w4_gemm(x, p["kernel_q4p"], p["kernel_scale4p"])
        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        for suffix in ("gemv", "gemm"):
            getattr(cdll, f"halva_probe_clear_{suffix}")()
        launch()
        torch.cuda.synchronize()
        # a kernel instantiated in both sources may run either's copy: the
        # stamps are in the one that ran
        st = None
        for suffix in ("gemv", "gemm"):
            buf = (ctypes.c_longlong * (1 << 18))()
            getattr(cdll, f"halva_probe_read_{suffix}")(buf,
                                                        ctypes.sizeof(buf))
            got = np.frombuffer(buf, dtype=np.int64).reshape(-1, 16)
            got = got[got[:, 3] > 0].astype(np.float64)
            if st is None or len(got) > len(st):
                st = got
        tiles = st[:, 3]
        per = ", ".join(f"{ph} {float((st[:, i] / tiles).mean()):.0f}"
                        for i, ph in enumerate(("wait", "issue", what)))
        start = st[:, 4].min()
        loop = float((st[:, 5] - st[:, 4]).mean()) / 1e3
        late = float((st[:, 4] - start).max()) / 1e3
        ended = st[:, 6] > 0
        line = (f"{name} rows={rows} K={k} N={n} plan {tuple(plan)}: cycles "
                f"per K tile, lane 0 of each warp ({float(tiles.mean()):.1f}"
                f" tiles a warp): {per}; loop {loop:.2f} us, last warp's "
                f"start {late:.2f} us after the first's; epilogue to the "
                f"ticket {float((st[ended, 6] - st[ended, 5]).mean()) / 1e3:.2f}"
                f" us")
        merged = st[:, 7] > 0
        if merged.any():
            line += (f", last block's merge "
                     f"{float((st[merged, 7] - st[merged, 6]).mean()) / 1e3:.2f}"
                     " us")
        span = float(max(st[:, 6].max(), st[:, 7].max()) - start) / 1e3
        print(line + f"; first loop start to last store {span:.2f} us",
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("w4_gemv_phases: needs a CUDA device")
    if sys.argv[1:2] == ["--stamped"]:
        run_stamped(sys.argv[2])
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    for name, product, what in (("stamped", True, "compute"),
                                ("stamped_convert", False, "convert")):
        print(f"csrc/dq_rows.cuh stamped ({what}: "
              f"{'conversion and mma.sync' if product else 'conversion alone'}"
              "):", flush=True)
        env = dict(os.environ, PYTHONPATH=stamped_copy(name, product))
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--stamped", what], env=env, check=True)


if __name__ == "__main__":
    main()
