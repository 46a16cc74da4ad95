"""Test harness config: force an 8-device virtual CPU mesh.

Multi-chip sharding paths (FSDP/TP over Mesh) are validated on virtual CPU
devices per SURVEY.md §4 — no TPU slice is needed for unit tests.

Note: plugins (jaxtyping) may import jax before this conftest runs, so env
vars alone are too late; jax.config.update works until the backend is
actually initialized.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_DEFAULT_MATMUL_PRECISION"] = "highest"
# Hermetic quant/serving config: the parity tests document DEFAULT-env
# behavior (e.g. manual-TP int4 == single-device requires W4A8 off; the
# W4A8 per-shard activation scale is a requantization). A driver or
# queue script exporting bench serving knobs must not leak in; tests
# that want a knob set it via monkeypatch.
for _knob in (
    "HALVA_W4A8", "HALVA_W8A8", "HALVA_BENCH_KV", "HALVA_DECODE_ROWS",
    "HALVA_TP_IMPL", "HALVA_SCOPED_VMEM_MB", "HALVA_JAX_CACHE",
):
    os.environ.pop(_knob, None)

import jax

jax.config.update("jax_platforms", "cpu")
# fp32 matmuls for parity tests
jax.config.update("jax_default_matmul_precision", "highest")
# NEVER read/write a persistent compilation cache in tests: XLA:CPU AOT
# executables are not machine-portable (the cache key omits host CPU
# features), and this suite moves across fleet hosts with /tmp and
# ~/.cache intact. A stale foreign-machine executable loads with only a
# cpu_aot_loader warning and rounds differently (FMA/vectorization),
# flipping near-tie greedy argmaxes — the round-4 "flaky" manual-TP
# int4 parity failures. In-process CLI entry points
# (utils/jaxcache.enable_persistent_cache) respect this master switch.
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere "
        "(tests/test_torch_cuda_kernels.py)",
    )
