"""The kernel build and dispatch rules of the port, checked without a GPU:
where nvcc is looked for, that a failed build raises with nvcc's stderr,
that a built library is reused by hash, and that a wrapper given a tensor
that is on neither the CPU nor a CUDA device raises instead of falling
back to its plain version."""

import os
import stat

import pytest
import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.decode_attention import decode_attend_layer
from halva_tpu_torch.ops.flash_attention import flash_attention


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
    assert _kernels.build() == first
    assert calls.read_text().count("x") == 1


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
    assert sum(_kernels.launches.values()) == 0
