"""The PyTorch port imports no JAX, no Triton, and builds nothing on
import. Checked in a fresh interpreter where `import jax` fails: every
module of halva_tpu_torch must still import, and it pulls in no module of
halva_tpu at all, not even one that imports no JAX (the port keeps its own
copies of config, constants, conversation and mm_utils)."""

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "halva_tpu_torch")

CHILD = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, %r)
import halva_tpu_torch
from halva_tpu_torch import _kernels
names = [m.name for m in pkgutil.walk_packages(
    halva_tpu_torch.__path__, "halva_tpu_torch.")]
IMAGES = "halva_tpu_torch.mm_utils"  # decodes images: the one PIL user
for name in names:
    if name != IMAGES:
        importlib.import_module(name)
pil = "PIL" in sys.modules
importlib.import_module(IMAGES)
print(json.dumps({
    "modules": names,
    "triton": "triton" in sys.modules,
    "pil": pil,
    "halva_tpu": sorted(m for m in sys.modules
                        if m.split(".")[0] == "halva_tpu"),
    "lib_loaded": _kernels.lib.cache_info().currsize,
}))
"""


def test_every_module_imports_without_jax():
    p = subprocess.run(
        [sys.executable, "-c", CHILD % REPO], capture_output=True,
        text=True, cwd=REPO, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert "halva_tpu_torch.evals.runner" in out["modules"]
    assert "halva_tpu_torch.ops.generate" in out["modules"]
    for name in ("lora", "dpa", "trainer", "checkpoint"):
        assert f"halva_tpu_torch.train.{name}" in out["modules"]
    assert not out["triton"]
    # PIL comes in with mm_utils, which is imported where an image is decoded
    assert not out["pil"]
    for name in ("config", "constants", "conversation", "ops.beam",
                 "ops.speculative"):
        assert f"halva_tpu_torch.{name}" in out["modules"]
    assert out["halva_tpu"] == []
    assert out["lib_loaded"] == 0  # no kernel built or loaded on import


def test_sources_use_no_library_attention():
    """No JAX, Triton, library attention or torch.compile anywhere in the
    package (the train modules and the flash backward included)."""
    banned = re.compile(
        r"import jax|from jax|scaled_dot_product_attention|torch\.compile"
        r"|import triton|flash_attn")
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                for i, line in enumerate(open(path), 1):
                    if banned.search(line):
                        hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_sources_name_the_reference_package_only_as_paths():
    """No `halva_tpu.<module>` and no import of halva_tpu in any file of the
    package or in chip_smoke.py: the reference is named by file paths
    (halva_tpu/ops/...), as in the `replaces` fields, and nowhere else."""
    dotted = re.compile(r"\bhalva_tpu\.(?!py\b)|from halva_tpu |"
                        r"import halva_tpu\b(?!_torch)")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    hits = []
    for path in paths:
        for i, line in enumerate(open(path), 1):
            if dotted.search(line):
                hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_decode_kernels_are_hand_written():
    """K4's and K5's CUDA sources call no library either; both take the
    cache formats and the cp.async copies from the shared header, and each
    runs its own staged tile loop with the one-launch merge of its key
    splits (a ticket, no float atomics); K5's products are mma.sync."""
    csrc = os.path.join(PKG, "csrc")
    library = re.compile(r"cublas|cudnn|cutlass|torch|#include <(?!cuda_bf16|"
                         r"cuda_runtime|stdint)")
    for name in ("decode_attn.cu", "fold_attn.cu", "decode_common.cuh"):
        text = open(os.path.join(csrc, name)).read()
        code = "\n".join(ln.split("//")[0] for ln in text.splitlines())
        assert not library.search(code), name
        if name.endswith(".cu"):
            assert '#include "decode_common.cuh"' in code, name
    fold = open(os.path.join(csrc, "fold_attn.cu")).read()
    assert "fold_attn_kernel" in fold and 'extern "C" int halva_fold_attn' in fold
    assert "cp_async16(" in fold and "mma_16816(" in fold
    assert "atomicAdd(&a.tickets[work], 1)" in fold
    k4 = open(os.path.join(csrc, "decode_attn.cu")).read()
    assert "cp_async16(" in k4
    assert "atomicAdd(&tickets[head], 1)" in k4
    for src in (k4, fold):
        assert not re.search(r"atomicAdd\((?!&(a\.)?tickets)", src)
    assert "cp.async" in open(os.path.join(csrc, "decode_common.cuh")).read()


def test_dq_gemm_is_hand_written_with_one_path_per_row_range():
    """K7's and K8's source calls no library (cuda.h only for the tensor-map
    types; the encoder is looked up at run time). Above 32 rows it
    runs the TMA + wgmma kernel, with its split partials summed by the last
    block's ticket (no float atomics); up to 32 rows the decode-row loop of
    dq_rows.cuh (shared with K6), instantiated for row chunks of 8, 16 and
    32 rows (one to four n8 tiles), and no other mma.sync loop."""
    from halva_tpu_torch import _kernels

    # with the headers it includes: the Hopper helpers, which hold the PTX,
    # and the decode-row loop
    code = ""
    for name in ("dq_gemm.cu", "hopper_common.cuh", "dq_rows.cuh"):
        text = open(os.path.join(PKG, "csrc", name)).read()
        code += "\n".join(ln.split("//")[0] for ln in text.splitlines())
    assert '#include "hopper_common.cuh"' in code
    assert '#include "dq_rows.cuh"' in code
    library = re.compile(r"cublas|cudnn|cutlass|cute|torch|#include <(?!cuda\."
                         r"h>|cuda_bf16|cuda_runtime|stdint)")
    assert not library.search(code)
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.2d",
                "setmaxnreg.dec", "mbarrier.try_wait"):
        assert ptx in code, ptx
    assert "__grid_constant__ CUtensorMap" in code
    assert "cudaGetDriverEntryPoint" in code and "-lcuda" not in " ".join(
        _kernels.NVCC_FLAGS)
    assert re.findall(r"launch_rows<(\d+), MODE>", code) == ["1", "2", "4"]
    assert "dq_gemm_kernel" not in code
    assert "atomicAdd(&tickets[tile], 1)" in code
    assert not re.search(r"atomicAdd\((?!&(a\.)?tickets)", code)


def test_w4_gemv_is_hand_written_on_the_decode_row_loop():
    """K6's source, with the decode-row loop it runs, calls no library; its
    only atomicAdd is the split merge's ticket; its products are
    tensor-core mma.sync with fp32 sums, its int4 conversion the magic
    number (no int-to-float conversion of a nibble), and its weight tiles
    stream through shared memory by cp.async."""
    code = ""
    for name in ("w4_gemv.cu", "dq_rows.cuh", "mma_bf16.cuh"):
        text = open(os.path.join(PKG, "csrc", name)).read()
        code += "\n".join(ln.split("//")[0] for ln in text.splitlines())
    assert '#include "dq_rows.cuh"' in code
    library = re.compile(r"cublas|cudnn|cutlass|cute|torch|#include <(?!cuda_"
                         r"bf16|cuda_runtime|stdint)")
    assert not library.search(code)
    assert 'extern "C" int halva_w4_gemv' in code
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    assert "cp.async.cg.shared.global" in code
    assert "cp.async.wait_group" in code
    assert "atomicAdd(&a.tickets[tile], 1)" in code
    assert len(re.findall(r"atomicAdd\(", code)) == 1
    # the magic number: nibble ^ 8 in the mantissa of bf16 128.0, minus 136
    assert "0x000F000Fu" in code and "0x43084308u" in code
    assert not re.search(r"\(float\)|__int2float|__i2f", code)


def test_flash_kernels_are_hand_written_and_deterministic():
    """The flash kernels' CUDA sources call no library (no cuBLAS, cuDNN,
    CUTLASS or torch; cuda.h only for the tensor-map types, the encoder is
    looked up at run time) and K3 sums dK and dV over the query heads of a
    KV head without atomics, so the backward is deterministic. K1 is one
    Hopper kernel, and K2 and K3 one each: TMA copies and a producer
    warpgroup whose registers setmaxnreg moves, mbarrier waits, wgmma for
    every product; no mma.sync and no atomics, so the forward is
    deterministic too."""
    csrc = os.path.join(PKG, "csrc")
    library = re.compile(r"cublas|cudnn|cutlass|cute|torch|#include <(?!cuda\."
                         r"h>|cuda_bf16|cuda_runtime|stdint)")
    code = {}
    for name in ("flash_fwd.cu", "flash_bwd.cu", "mma_bf16.cuh",
                 "hopper_common.cuh", "flash_common.cuh"):
        text = open(os.path.join(csrc, name)).read()
        code[name] = "\n".join(ln.split("//")[0] for ln in text.splitlines())
        assert not library.search(code[name]), name
    fwd = code["flash_fwd.cu"]
    assert '#include "hopper_common.cuh"' in fwd
    assert '#include "mma_bf16.cuh"' not in fwd
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                "setmaxnreg"):
        assert ptx in fwd + code["hopper_common.cuh"], ptx
    assert "setmaxnreg.dec" in fwd and "setmaxnreg.inc" in fwd
    assert "__grid_constant__ CUtensorMap" in fwd
    assert "mma_16816" not in fwd and "mma.sync" not in fwd
    assert "atomic" not in fwd
    assert len(re.findall(r"__global__ void", fwd)) == 1
    bwd = code["flash_bwd.cu"]
    assert '#include "hopper_common.cuh"' in bwd
    assert '#include "mma_bf16.cuh"' not in bwd
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                "setmaxnreg"):
        assert ptx in bwd + code["hopper_common.cuh"], ptx
    assert "setmaxnreg.dec" in bwd and "setmaxnreg.inc" in bwd
    assert "__grid_constant__ CUtensorMap" in bwd
    assert "mma_16816" not in bwd and "mma.sync" not in bwd
    assert "atomic" not in bwd
    for kernel in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert f"__global__ void __launch_bounds__(NTHREADS, 1)\n{kernel}" in bwd
