"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (they build csrc/ on first use) and skip
elsewhere. They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: bf16 outputs within one bf16 step plus the P rounding of the
kernels' tensor-core PV product: |got - plain| <= 1e-2 + 1e-2 * |plain| on
live rows (the same bound chip_smoke.py states)."""

import pytest
import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
)
from halva_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,causal", [(8, True), (8, False), (2, True)])
def test_flash_fwd_matches_plain(cuda, kvh, causal):
    b, s, h, d = 2, 200, 8, 128
    q = torch.randn(b, s, h, d, generator=cuda, device="cuda").bfloat16()
    k = torch.randn(b, s, kvh, d, generator=cuda, device="cuda").bfloat16()
    v = torch.randn(b, s, kvh, d, generator=cuda, device="cuda").bfloat16()
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[1, 150:] = 0
    seg[0, 90:] = 2
    before = _kernels.launches["flash_fwd"]
    got = flash_attention(q, k, v, seg, seg, causal=causal)
    assert _kernels.launches["flash_fwd"] == before + 1
    want = flash_attention_plain(q, k, v, seg, seg, causal=causal)
    live = seg != 0
    _close(got[live], want[live])


@pytest.mark.cuda
@pytest.mark.parametrize("kvh", [8, 2])
def test_decode_attn_matches_plain(cuda, kvh):
    b, h, sp, sg, d = 3, 8, 300, 128, 128

    def r(*shape):
        return torch.randn(*shape, generator=cuda, device="cuda").bfloat16()

    q = r(b, 1, h, d)
    pc = {"k": r(b, kvh, sp, d), "v": r(b, kvh, sp, d)}
    gc = {"k": r(b, kvh, sg, d), "v": r(b, kvh, sg, d)}
    seg = torch.ones(b, sp, dtype=torch.int32, device="cuda")
    seg[0, 250:] = 0
    seg[2] = 0
    gen_valid = (torch.arange(sg, device="cuda")[None, :]
                 <= torch.tensor([0, 40, 127], device="cuda")[:, None])
    before = _kernels.launches["decode_attn"]
    got = decode_attend_layer(q, pc, seg, gc, gen_valid)
    assert _kernels.launches["decode_attn"] == before + 1
    _close(got, decode_attend_plain(q, pc, seg, gc, gen_valid))
