"""Build and load the hand-written CUDA kernels in `csrc/`.

The sources are compiled with `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes`. Nothing is built or
loaded at import: the first kernel launch builds into `<repo>/build/kernels/
<hash of the sources and flags>/`, and later processes reuse that library.

`launches` counts kernel launches by name. A wrapper adds one exactly where
it launches its kernel, so a run can show that its path went through them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_attn.cu", "fold_attn.cu",
           "w4_gemv.cu", "dq_gemm.cu")
# included by sources; part of the build hash
HEADERS = ("mma_bf16.cuh", "decode_common.cuh", "hopper_common.cuh",
           "flash_common.cuh", "dq_rows.cuh")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libhalva_kernels.so"

launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, then `/usr/local/cuda/bin/nvcc`, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if this hash has no library yet; return its path.

    One nvcc per source, all started together, then one link. nvcc's output
    (including `-Xptxas -v` register and spill counts) is kept as
    `build.log` beside the library. Raises with nvcc's stderr on failure.
    """
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # build in a private directory, then rename: a process building at the
    # same time never loads a half-written library
    work = tempfile.mkdtemp(dir=out_dir)
    nvcc = find_nvcc()
    try:
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]
        results = [(c, p.returncode, out, err)
                   for c, p, (out, err) in zip(cmds, procs, outs)]
        if all(rc == 0 for _, rc, _, _ in results):
            tmp = os.path.join(work, LIB_NAME)
            link = [nvcc, "-shared", "-o", tmp, *objs]
            p = subprocess.run(link, capture_output=True, text=True)
            results.append((link, p.returncode, p.stdout, p.stderr))
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            for c, _, out, err in results:
                f.write(" ".join(c) + "\n" + out + err)
        failed = [(c, rc, err) for c, rc, _, err in results if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(c[-1])} (exit {rc}):\n{err}"
                for c, rc, err in failed))
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """nvcc's output for the current sources ('' if not built yet)."""
    path = os.path.join(BUILD_ROOT, _source_hash(), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    cdll = ctypes.CDLL(build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.halva_flash_fwd_bf16.argtypes = (
        [p] * 7 + [i] * 6 + [f] + [i] * 5 + [p])
    cdll.halva_flash_fwd_bf16.restype = i
    cdll.halva_flash_bwd_dq_bf16.argtypes = (
        [p] * 9 + [i] * 6 + [f] + [i] * 5 + [p])
    cdll.halva_flash_bwd_dq_bf16.restype = i
    cdll.halva_flash_bwd_dkv_bf16.argtypes = (
        [p] * 10 + [i] * 6 + [f] + [i] * 5 + [p])
    cdll.halva_flash_bwd_dkv_bf16.restype = i
    cdll.halva_decode_attn_bf16.argtypes = [p] * 10 + [i] * 9 + [f, p]
    cdll.halva_decode_attn_bf16.restype = i
    cdll.halva_decode_attn_kv8.argtypes = [p] * 14 + [i] * 9 + [f, p]
    cdll.halva_decode_attn_kv8.restype = i
    cdll.halva_decode_attn_kv4.argtypes = [p] * 14 + [i] * 10 + [f, p]
    cdll.halva_decode_attn_kv4.restype = i
    cdll.halva_fold_attn.argtypes = [i] + [p] * 16 + [i] * 12 + [f, p]
    cdll.halva_fold_attn.restype = i
    cdll.halva_w4_gemv.argtypes = [p] * 6 + [i] * 7 + [p]
    cdll.halva_w4_gemv.restype = i
    cdll.halva_dq_gemm.argtypes = [i] + [p] * 6 + [i] * 7 + [p]
    cdll.halva_dq_gemm.restype = i
    cdll.halva_cuda_error_string.argtypes = [i]
    cdll.halva_cuda_error_string.restype = ctypes.c_char_p
    return cdll


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().halva_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({msg})")


MAX_TICKETS = 1 << 16
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def tickets(device: torch.device) -> torch.Tensor:
    """Per-device zeroed int32 tickets of the split reductions (K4's and
    K5's key splits, K6's, K7's and K8's split-K). The last block of a tile
    resets its ticket to 0, so the buffer is zeroed once and reused by every
    launch on the device's streams in order."""
    t = _TICKETS.get(device)
    if t is None:
        t = torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t
