"""The kernel build and dispatch rules of the port, checked without a GPU:
where nvcc is looked for, that a failed build raises with nvcc's stderr,
that the sources compile in parallel (one nvcc per source, then one link)
and a built library is reused by hash, and that a wrapper given a tensor
that is on neither the CPU nor a CUDA device raises instead of falling
back to its plain version."""

import os
import stat

import pytest
import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.decode_attention import decode_attend_layer
from halva_tpu_torch.ops.flash_attention import flash_attention
from halva_tpu_torch.ops.w4_matmul import w4_dense_stacked


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_find_nvcc_prefers_cuda_home(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = _fake_nvcc(home / "bin", "exit 0")
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert _kernels.find_nvcc() == nvcc


def test_find_nvcc_missing_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(os, "access", lambda *a: False)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.find_nvcc()


def test_build_failure_raises_with_stderr(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: bad kernel' >&2; exit 2")
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_kernels, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _kernels.build()
    out_dir = tmp_path / "build" / _kernels._source_hash()
    assert not [f for f in os.listdir(out_dir) if f.endswith(".so")]
    assert "bad kernel" in _kernels.build_log()


def test_build_is_reused_by_source_hash(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    # the fake compiler writes its -o target and counts its runs
    nvcc = _fake_nvcc(
        tmp_path,
        'echo x >> ' + str(calls) + '\n'
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"',
    )
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_kernels, "BUILD_ROOT", str(tmp_path / "build"))
    first = _kernels.build()
    assert first.endswith(os.path.join(_kernels._source_hash(),
                                       _kernels.LIB_NAME))
    # one compile per source and one link, and nothing more on reuse
    built = calls.read_text().count("x")
    assert built == len(_kernels.SOURCES) + 1
    assert _kernels.build() == first
    assert calls.read_text().count("x") == built


def test_non_cpu_non_cuda_tensors_raise():
    """A wrapper takes its plain version only for CPU tensors; any other
    device must launch the kernel or raise, never fall back."""
    meta = dict(device="meta")
    q = torch.empty(1, 8, 2, 128, dtype=torch.bfloat16, **meta)
    seg = torch.empty(1, 8, dtype=torch.int32, **meta)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, seg, seg)
    cache = {"k": torch.empty(1, 2, 8, 128, dtype=torch.bfloat16, **meta)}
    cache["v"] = cache["k"]
    valid = torch.empty(1, 8, dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attend_layer(q[:, :1], cache, seg, cache, valid)
    qcache = {"k4": torch.empty(1, 2, 4, 128, dtype=torch.int8, **meta)}
    qcache["v4"] = qcache["k4"]
    qcache["k_scale"] = torch.empty(1, 2, 2, 4, dtype=torch.bfloat16, **meta)
    qcache["v_scale"] = qcache["k_scale"]
    gcache = {"k": torch.empty(1, 2, 8, 128, dtype=torch.int8, **meta)}
    gcache["v"] = gcache["k"]
    gcache["k_scale"] = torch.empty(1, 2, 8, dtype=torch.bfloat16, **meta)
    gcache["v_scale"] = gcache["k_scale"]
    with pytest.raises(ValueError, match="CUDA"):
        decode_attend_layer(q[:, :1], qcache, seg, gcache, valid)
    w = {"kernel_q4p": torch.empty(128, 64, dtype=torch.int8, **meta),
         "kernel_scale4p": torch.empty(2, 1, 64, dtype=torch.bfloat16,
                                       **meta)}
    with pytest.raises(ValueError, match="CUDA"):
        w4_dense_stacked(torch.empty(2, 128, dtype=torch.bfloat16, **meta), w)
    assert sum(_kernels.launches.values()) == 0


def test_every_source_is_built_and_hashed(tmp_path, monkeypatch):
    """Every .cu under csrc/ is in SOURCES and every .cuh in HEADERS (K7 and
    K8 live in dq_gemm.cu), and a change to any of them changes the build
    hash."""
    on_disk = sorted(os.listdir(_kernels.CSRC))
    assert sorted(_kernels.SOURCES + _kernels.HEADERS) == on_disk
    assert "dq_gemm.cu" in _kernels.SOURCES
    copy = tmp_path / "csrc"
    copy.mkdir()
    for name in on_disk:
        (copy / name).write_bytes(
            open(os.path.join(_kernels.CSRC, name), "rb").read())
    monkeypatch.setattr(_kernels, "CSRC", str(copy))
    base = _kernels._source_hash()
    for name in ("dq_gemm.cu", "mma_bf16.cuh"):
        path = copy / name
        original = path.read_bytes()
        path.write_bytes(original + b"\n// touched\n")
        assert _kernels._source_hash() != base, name
        path.write_bytes(original)
    assert _kernels._source_hash() == base


def test_gemm_wrappers_refuse_non_cpu_non_cuda_tensors():
    """K7's and K8's wrappers, and w8_dense, which launches K8: the plain
    version is for CPU tensors only."""
    from halva_tpu_torch.ops import quant
    from halva_tpu_torch.ops.int8_matmul import int8_matmul
    from halva_tpu_torch.ops.w4_matmul import w4_decode_matmul, w4_gemm

    meta = dict(device="meta")
    x = torch.empty(20, 128, dtype=torch.bfloat16, **meta)
    w = torch.empty(128, 64, dtype=torch.int8, **meta)
    s4 = torch.empty(2, 1, 64, dtype=torch.bfloat16, **meta)
    s8 = torch.empty(1, 64, dtype=torch.bfloat16, **meta)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        w4_gemm(x, w, s4)
    with pytest.raises(ValueError, match="CUDA"):
        w4_decode_matmul(x, {"kernel_q4p": w, "kernel_scale4p": s4})
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul(x, w, s8)
    with pytest.raises(ValueError, match="CUDA"):
        quant.w8_dense(x, w, s8)
    assert sum(_kernels.launches.values()) == 0
