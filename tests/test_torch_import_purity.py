"""The PyTorch port imports no JAX, no Triton, and builds nothing on
import. Checked in a fresh interpreter where `import jax` fails: every
module of halva_tpu_torch must still import, and the only halva_tpu
modules it may pull in are the framework-free config and constants."""

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
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "triton": "triton" in sys.modules,
    "pil": "PIL" in sys.modules,
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
    assert not out["triton"]
    assert not out["pil"]  # PIL is imported where an image is decoded
    assert set(out["halva_tpu"]) <= {
        "halva_tpu", "halva_tpu.config", "halva_tpu.constants"}
    assert out["lib_loaded"] == 0  # no kernel built or loaded on import


def test_sources_use_no_library_attention():
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
