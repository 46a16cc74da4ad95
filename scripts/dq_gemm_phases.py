#!/usr/bin/env python3
"""Where a K tile of the dequantizing GEMM's 128-row path spends its time.

    python3 scripts/dq_gemm_phases.py

First the old loop: builds scripts/dq_gemm_phases.cu (the cp.async +
convert + mma.sync loop that halva_tpu_torch/csrc/dq_gemm.cu ran above 32
rows before its redesign, with clock64 stamps at the phase boundaries of
every K tile) with nvcc into build/probe/, runs it under the old launch plan
at the K7 (packed int4, g=128) and K8 (int8) shapes of llava-1.5-7b at 80
and 2,492 rows and CLIP's 4096x1024 at 2,308 rows, and prints, per shape,
the launch's device time and the mean cycles per K tile of each phase
(wait: cp.async.wait_group and the barrier; issue: the next tile's cp.async;
convert; barrier; mma: ldmatrix and mma.sync) for the first and the last
warp of a block.

Then the TMA + wgmma kernel that replaced it: copies halva_tpu_torch into
build/probe/stamped/, stamps its csrc/dq_gemm.cu (clock64 at the phase
boundaries of a consumer warpgroup's K tile: wait for the stage, convert,
wgmma wait + barrier, wgmma issue; globaltimer at the loop's ends, after the
split epilogue's ticket and after the last block's sum) and prints the
same per-tile means and the epilogue's and the split sum's microseconds,
from a second process that imports the stamped copy. Needs a CUDA card and
nvcc; imports no JAX.
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
# last: the stamped copy, on PYTHONPATH in the second process, comes first
sys.path.append(ROOT)

from halva_tpu_torch import _kernels  # noqa: E402

PHASES = ("wait", "issue", "convert", "barrier", "mma")


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libdq_gemm_phases.so")
    cmd = [_kernels.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib,
           os.path.join(HERE, "dq_gemm_phases.cu")]
    subprocess.run(cmd, check=True)
    cdll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.probe_dq_gemm.argtypes = [i] + [p] * 6 + [i] * 6 + [p]
    cdll.probe_dq_gemm.restype = i
    return cdll


def old_plan(m: int, k: int, n: int):
    """The 128-row branch of the old gemm_plan: 128 x 128 tiles, K split
    while the tiles alone leave fewer than 264 blocks."""
    tiles = -(-m // 128) * -(-n // 128)
    kt = k // 64
    splits = max(1, min(264 // tiles, kt // 4, 16))
    tps = -(-kt // splits)
    return -(-kt // tps), tps, tiles


def run(cdll, mode: int, m: int, k: int, n: int, groups: int, gen):
    dev = "cuda"
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    if mode == 0:
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand(n, generator=gen, device=dev) * 0.002).bfloat16()
    else:
        w = torch.randint(-128, 128, (k, n // 2), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand(2, groups, n // 2, generator=gen, device=dev)
             * 0.02).bfloat16()
    splits, tps, tiles = old_plan(m, k, n)
    y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    partial = torch.empty(splits if splits > 1 else 0, m, n,
                          dtype=torch.float32, device=dev)
    tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    stamps = torch.zeros(tiles * splits, 16, dtype=torch.int64, device=dev)

    def launch():
        err = cdll.probe_dq_gemm(
            mode, x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), m, k, n, groups, splits,
            tps, stamps.data_ptr())
        if err:
            raise RuntimeError(f"probe launch: CUDA error {err}")

    for _ in range(3):
        launch()
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    st = stamps.cpu().double()
    nkt = st[:, 7]
    what = ("K8" if mode == 0 else f"K7 G={groups}")
    line = (f"{what} M={m} K={k} N={n}: {tiles} tiles x {splits} splits of "
            f"{tps} K tiles, {statistics.median(times):.4f} ms")
    for name, off in (("warp 0", 0), ("last warp", 8)):
        per = [float((st[:, off + p] / nkt).mean()) for p in range(5)]
        loop = float((st[:, off + 5] / nkt).mean())
        ns = float((st[:, off + 6] / nkt).mean())
        parts = ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, per))
        line += (f"; {name}: cycles per K tile {parts} (loop {loop:.0f} "
                 f"cycles = {ns:.0f} ns)")
    print(line, flush=True)


# (anchor in csrc/dq_gemm.cu, what the stamped copy puts in its place)
STAMPS = (
    ("constexpr int WS_BM = 128;", """__device__ long long g_probe[1 << 17];
__device__ __forceinline__ long long pclk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ long long pgt() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
constexpr int WS_BM = 128;"""),
    ("""  for (int i = 0; i < nkt; ++i) {
    const int st = i % S::STAGES;""", """  long long ph[4] = {0, 0, 0, 0};
  const long long g0 = pgt();
  long long tp = pclk();
  for (int i = 0; i < nkt; ++i) {
    const int st = i % S::STAGES;"""),
    ("""    mbar_wait(full + 8 * st, (i / S::STAGES) & 1);""",
     """    mbar_wait(full + 8 * st, (i / S::STAGES) & 1);
    { long long t = pclk(); ph[0] += t - tp; tp = t; }"""),
    ("""    // the converted tile is read by wgmma""",
     """    { long long t = pclk(); ph[1] += t - tp; tp = t; }
    // the converted tile is read by wgmma"""),
    ("""    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");""",
     """    { long long t = pclk(); ph[2] += t - tp; tp = t; }
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");"""),
    ("""    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");""",
     """    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    { long long t = pclk(); ph[3] += t - tp; tp = t; }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  const long long g1 = pgt();
  const long pb = ((long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x) * 2 + wg;
  const bool pw = wtid == 0 && pb < (1 << 13);
  if (pw) {
    long long* o = g_probe + pb * 16;
    o[0] = ph[0]; o[1] = ph[1]; o[2] = ph[2]; o[3] = ph[3];
    o[4] = g0; o[5] = g1; o[6] = nkt; o[7] = 0; o[8] = 0;
  }"""),
    ("""    return;
  }

  float* mine = partial + (long)blockIdx.z""", """    if (pw) g_probe[pb * 16 + 7] = pgt();
    return;
  }

  float* mine = partial + (long)blockIdx.z"""),
    ("""  if (!*is_last) return;""", """  if (pw) g_probe[pb * 16 + 7] = pgt();
  if (!*is_last) return;"""),
    ("""      sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}""", """      sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (pw) g_probe[pb * 16 + 8] = pgt();
}"""),
)
READERS = """
extern "C" int halva_probe_read(void* host, long bytes) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, bytes);
}
extern "C" int halva_probe_clear() {
  static long long zeros[1 << 17];
  return (int)cudaMemcpyToSymbol(g_probe, zeros, sizeof(zeros));
}
"""
# (what, mode, M, K, N, G, forced splits or None for gemm_plan's)
NEW_CASES = (
    ("K8", 0, 2492, 4096, 11008, 1, None),
    ("K8", 0, 2492, 11008, 4096, 1, None),
    ("K8", 0, 2308, 4096, 1024, 1, None),
    ("K8", 0, 2308, 4096, 1024, 1, 3),
    ("K7 G=32", 1, 80, 4096, 4096, 32, None),
    ("K7 G=32", 1, 80, 4096, 11008, 32, None),
    ("K7 G=32", 1, 80, 11008, 4096, 86, None),
    ("K7 G=1", 1, 80, 4096, 11008, 1, None),
    ("K7 G=32", 1, 2492, 4096, 11008, 32, None),
)


def stamped_copy() -> str:
    """halva_tpu_torch copied under build/probe/stamped/ with the stamps in
    its csrc/dq_gemm.cu; raises if an anchor is missing."""
    root = os.path.join(ROOT, "build", "probe", "stamped")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "halva_tpu_torch"),
                    os.path.join(root, "halva_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "halva_tpu_torch", "csrc", "dq_gemm.cu")
    src = open(path).read()
    for anchor, stamped in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:60]!r}")
        src = src.replace(anchor, stamped)
    open(path, "w").write(src + READERS)
    return root


def run_stamped(gen) -> None:
    """In a process that imported the stamped copy: each of NEW_CASES once
    after three warm-up launches, its stamps averaged over blocks."""
    import numpy as np

    from halva_tpu_torch.ops import int8_matmul as k8

    if "stamped" not in _kernels.__file__:
        raise RuntimeError(f"not the stamped copy: {_kernels.__file__}")
    cdll = _kernels.lib()
    cdll.halva_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_long]
    dev = "cuda"
    for what, mode, m, k, n, groups, forced in NEW_CASES:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        if mode == 0:
            w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            s = (torch.rand(n, generator=gen, device=dev) * 0.002).bfloat16()
        else:
            w = torch.randint(-128, 128, (k, n // 2), generator=gen,
                              device=dev, dtype=torch.int8)
            s = (torch.rand(2, groups, n // 2, generator=gen, device=dev)
                 * 0.02).bfloat16()
        plan = k8.gemm_plan(m, k, n, w.shape[-1])
        if forced:
            splits, tps = k8.split_k(k // k8.TILE_K, forced)
            plan = plan._replace(splits=splits, tps=tps)

        def launch():
            k8.launch_dq_gemm(mode, "probe", x, w, s, n, groups, plan)

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        cdll.halva_probe_clear()
        launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (1 << 17))()
        cdll.halva_probe_read(buf, ctypes.sizeof(buf))
        st = np.frombuffer(buf, dtype=np.int64).reshape(-1, 16)
        st = st[st[:, 6] > 0].astype(np.float64)
        nkt = st[:, 6]
        per = ", ".join(f"{name} {float((st[:, i] / nkt).mean()):.0f}"
                        for i, name in enumerate(
                            ("wait", "convert", "wgmma wait + barrier",
                             "wgmma issue")))
        ns = float(((st[:, 5] - st[:, 4]) / nkt).mean())
        line = (f"{what} M={m} K={k} N={n} plan {tuple(plan)}: cycles per "
                f"K tile, warpgroup thread 0: {per} ({ns:.0f} ns a tile)")
        ended = st[:, 7] > 0
        line += (f"; epilogue to the ticket "
                 f"{float((st[ended, 7] - st[ended, 5]).mean()) / 1e3:.1f} us")
        summed = st[:, 8] > 0
        if summed.any():
            line += (f", last block's sum "
                     f"{float((st[summed, 8] - st[summed, 7]).mean()) / 1e3:.1f}"
                     " us")
        print(line, flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dq_gemm_phases: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:] == ["--stamped"]:
        run_stamped(gen)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    cdll = build()
    print("the old 128-row loop (cp.async, convert, mma.sync):", flush=True)
    for m in (80, 2492):
        for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
            run(cdll, 1, m, k, n, k // 128, gen)
        run(cdll, 0, m, 4096, 11008, 1, gen)
    run(cdll, 0, 2308, 4096, 1024, 1, gen)
    print("the TMA + wgmma kernel of csrc/dq_gemm.cu, stamped:", flush=True)
    env = dict(os.environ, PYTHONPATH=stamped_copy())
    subprocess.run([sys.executable, os.path.abspath(__file__), "--stamped"],
                   env=env, check=True)


if __name__ == "__main__":
    main()
