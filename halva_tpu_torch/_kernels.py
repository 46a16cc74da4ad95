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

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("flash_fwd.cu", "decode_attn.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if this hash has no library yet; return its path.

    nvcc's output (including `-Xptxas -v` register and spill counts) is kept
    as `build.log` beside the library. Raises with nvcc's stderr on failure.
    """
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # build under a temporary name, then rename: a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
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
    cdll.halva_flash_fwd_bf16.argtypes = [p] * 7 + [i] * 6 + [f, i, p]
    cdll.halva_flash_fwd_bf16.restype = i
    cdll.halva_decode_attn_bf16.argtypes = [p] * 8 + [i] * 6 + [f, p]
    cdll.halva_decode_attn_bf16.restype = i
    cdll.halva_cuda_error_string.argtypes = [i]
    cdll.halva_cuda_error_string.restype = ctypes.c_char_p
    return cdll


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().halva_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({msg})")
