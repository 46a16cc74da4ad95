"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (they build csrc/ on first use) and skip
elsewhere. They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: bf16 outputs within one bf16 step plus the P rounding of the
kernels' tensor-core PV product (or of the plain version's bf16 P times v
scale): |got - plain| <= 1e-2 + 1e-2 * |plain| on live rows (the same bound
chip_smoke.py states). K6 and its plain version both round nibble *
scale to bf16 for grouped scales (the Pallas kernel's rounding) and sum in
fp32; only the summation order and the bf16 output rounding differ. K2 and K3 (the flash backward) against
flash_attention_bwd_plain, which rounds P and dS to bf16 where the kernels
do: |got - plain| <= 2e-2 * (max|plain| + |plain|) on live rows, and the
relative norm of the difference <= 2e-3 (the bf16 output rounding, plus a
P or dS element whose fp32 value differs in its last bits between the two
and rounds to the neighbouring bf16 value). K5 rounds probability times v
scale to bf16 for its tensor-core PV product, as K1 does: the same bound,
for it and K4's beam mode. K1, K2 and K3 in their ALiBi, sliding-window
and q_offset modes are held to the same bounds. K7 and K8 (the M-tiled
GEMMs over packed int4 and int8 weights) sum bf16 products in fp32 like
their plain versions; a grouped K7 rounds nibble * scale to bf16 first (the
Pallas kernel's order), 2^-9 relative per weight: the same bound, taken
relative to the output's scale (|got - plain| <= 1e-2 * (max|plain| / 4 +
|plain|)), since a sum of thousands of products has entries near 0."""

import pytest
import torch

from halva_tpu_torch import _kernels
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
    fold_attend_layer,
    fold_attend_plain,
)
from halva_tpu_torch.ops.flash_attention import (
    BWD_DKV_KEYS,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_plain,
    flash_attention_delta,
    flash_attention_fwd,
    flash_attention_plain,
)
from halva_tpu_torch.ops import quant
from halva_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from halva_tpu_torch.ops.w4_matmul import (
    dequantize_int4,
    w4_dense_stacked,
    w4_dense_stacked_plain,
    w4_gemm,
    w4_gemm_plain,
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


@pytest.mark.cuda
@pytest.mark.parametrize("k,np_,groups", [(4096, 1376, 1), (4096, 1376, 32),
                                          (11008, 2048, 86)])
@pytest.mark.parametrize("b", [1, 4, 80])
def test_w4_gemv_matches_plain(cuda, b, k, np_, groups):
    w = torch.randint(-128, 128, (k, np_), generator=cuda, device="cuda",
                      dtype=torch.int8)
    s = (torch.rand(2, groups, np_, generator=cuda, device="cuda") * 0.02
         + 0.005).bfloat16()
    x = torch.randn(b, k, generator=cuda, device="cuda").bfloat16()
    p = {"kernel_q4p": w, "kernel_scale4p": s}
    before = _kernels.launches["w4_gemv"]
    got = w4_dense_stacked(x, p)
    assert _kernels.launches["w4_gemv"] == before + 1
    assert got.shape == (b, 2 * np_) and got.dtype == torch.bfloat16
    _close(got, w4_dense_stacked_plain(x, p))
    again = w4_dense_stacked(x, p)  # the split tickets were reset
    assert torch.equal(got, again)


def _quant_caches(gen, mode, b, kvh, sp, sg, d):
    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def sc(*shape, lo=0.01, hi=0.04):
        return (torch.rand(*shape, generator=gen, device="cuda") * (hi - lo)
                + lo).bfloat16()

    if mode == "kv4":
        s2 = -(-sp // 2)
        pc = {"k4": torch.randint(-128, 128, (b, kvh, s2, d), generator=gen,
                                  device="cuda", dtype=torch.int8),
              "k_scale": sc(b, 2, kvh, s2, lo=0.1, hi=0.3),
              "v_scale": sc(b, 2, kvh, s2, lo=0.1, hi=0.3)}
        pc["v4"] = torch.randint(-128, 128, pc["k4"].shape, generator=gen,
                                 device="cuda", dtype=torch.int8)
    else:
        pc = {"k": i8(b, kvh, sp, d), "v": i8(b, kvh, sp, d),
              "k_scale": sc(b, kvh, sp), "v_scale": sc(b, kvh, sp)}
    gc = {"k": i8(b, kvh, sg, d), "v": i8(b, kvh, sg, d),
          "k_scale": sc(b, kvh, sg), "v_scale": sc(b, kvh, sg)}
    return pc, gc


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kv8", "kv4"])
@pytest.mark.parametrize("kvh", [8, 2])
def test_decode_attn_quantized_matches_plain(cuda, mode, kvh):
    b, h, sp, sg, d = 3, 8, 301, 128, 128
    q = torch.randn(b, 1, h, d, generator=cuda, device="cuda").bfloat16()
    pc, gc = _quant_caches(cuda, mode, b, kvh, sp, sg, d)
    seg = torch.ones(b, sp, dtype=torch.int32, device="cuda")
    seg[0, 250:] = 0
    seg[2] = 0
    # garbage in the scales of masked keys must not reach the output
    pc["v_scale"].view(-1)[-1] = float("nan")
    gen_valid = (torch.arange(sg, device="cuda")[None, :]
                 <= torch.tensor([0, 40, 127], device="cuda")[:, None])
    gc["v_scale"][~gen_valid[:, None, :].expand_as(gc["v_scale"])] = float(
        "inf")
    name = "decode_attn_" + mode
    before = _kernels.launches[name]
    got = decode_attend_layer(q, pc, seg, gc, gen_valid)
    assert _kernels.launches[name] == before + 1
    assert torch.isfinite(got).all()
    _close(got, decode_attend_plain(q, pc, seg, gc, gen_valid))


def _fold_caches(gen, mode, b, gen_rows, kvh, sp, sg, d):
    if mode == "bf16":
        def r(*shape):
            return torch.randn(*shape, generator=gen,
                               device="cuda").bfloat16()

        return ({"k": r(b, kvh, sp, d), "v": r(b, kvh, sp, d)},
                {"k": r(gen_rows, kvh, sg, d), "v": r(gen_rows, kvh, sg, d)})
    pc, _ = _quant_caches(gen, mode, b, kvh, sp, sg, d)
    _, gc = _quant_caches(gen, "kv8", gen_rows, kvh, 2, sg, d)
    return pc, gc


FOLD_NAMES = {"bf16": "fold_attn", "kv8": "fold_attn_kv8",
              "kv4": "fold_attn_kv4"}
GRID_NAMES = {"bf16": "decode_attn_beam", "kv8": "decode_attn_kv8_beam",
              "kv4": "decode_attn_kv4_beam"}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("k,h,kvh", [(4, 8, 8), (2, 8, 8), (3, 8, 2),
                                     (8, 8, 8), (8, 8, 1), (5, 8, 2)])
def test_fold_attn_per_beam_and_k4_beam_mode_match_plain(cuda, mode, k, h,
                                                         kvh):
    """K5's per-beam gen stage and K4's beam mode against their plain
    versions and against each other: K*G = 2 .. 64 query rows per (item, kv
    head), so one block of 2, 4 or 8 rows, padded rows (K*G = 3 -> 4) and
    several 8-row chunks; an odd prompt length; an item with no visible
    prompt key; a beam with a single gen slot."""
    b, sp, sg, d = 3, 301, 128, 128
    q = torch.randn(b, k, h, d, generator=cuda, device="cuda").bfloat16()
    pc, gc = _fold_caches(cuda, mode, b, b * k, kvh, sp, sg, d)
    seg = torch.ones(b, sp, dtype=torch.int32, device="cuda")
    seg[0, 250:] = 0
    seg[2] = 0
    steps = torch.randint(0, sg, (b * k,), generator=cuda, device="cuda")
    steps[0] = 0
    gen_valid = torch.arange(sg, device="cuda")[None, :] <= steps[:, None]
    if mode != "bf16":  # garbage in the scales of masked keys
        gc["v_scale"][~gen_valid[:, None, :].expand_as(gc["v_scale"])] = (
            float("inf"))
    before = dict(_kernels.launches)
    got = fold_attend_layer(q, pc, seg, gc, gen_valid, fold_k=k)
    assert _kernels.launches[FOLD_NAMES[mode]] == before.get(
        FOLD_NAMES[mode], 0) + 1
    want = fold_attend_plain(q, pc, seg, gc, gen_valid, fold_k=k)
    assert torch.isfinite(got).all()
    _close(got, want)
    q1 = q.reshape(b * k, 1, h, d)
    grid = decode_attend_layer(q1, pc, seg, gc, gen_valid, beam_k=k,
                               beam_route="grid")
    assert _kernels.launches[GRID_NAMES[mode]] == before.get(
        GRID_NAMES[mode], 0) + 1
    _close(grid, decode_attend_plain(q1, pc, seg, gc, gen_valid, beam_k=k))
    # the fold route is K5
    routed = decode_attend_layer(q1, pc, seg, gc, gen_valid, beam_k=k,
                                 beam_route="fold")
    assert _kernels.launches[FOLD_NAMES[mode]] == before.get(
        FOLD_NAMES[mode], 0) + 2
    assert torch.equal(routed.reshape(b, k, h, d), got)
    # one bf16 step between the two routes: they sum in the same order
    torch.testing.assert_close(grid.reshape(b, k, h, d).float(), got.float(),
                               rtol=2**-7, atol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "kv8", "kv4"])
@pytest.mark.parametrize("k,h,kvh,sg", [(4, 8, 8, 128), (8, 8, 8, 256),
                                        (3, 8, 2, 128), (8, 8, 2, 200)])
def test_fold_attn_shared_gen_with_candidates_matches_plain(cuda, mode, k, h,
                                                            kvh, sg):
    """K5's shared gen stage: one gen cache row per item under gen_len, the
    K fresh candidates attended causally; an item with an empty gen cache
    and a masked prompt still sees its own candidates."""
    b, sp, d = 3, 301, 128
    q = torch.randn(b, k, h, d, generator=cuda, device="cuda").bfloat16()
    kc = torch.randn(b, k, kvh, d, generator=cuda, device="cuda").bfloat16()
    vc = torch.randn(b, k, kvh, d, generator=cuda, device="cuda").bfloat16()
    pc, gc = _fold_caches(cuda, mode, b, b, kvh, sp, sg, d)
    seg = torch.ones(b, sp, dtype=torch.int32, device="cuda")
    seg[0, 250:] = 0
    seg[2] = 0
    gen_len = torch.tensor([40, sg - k, 0], device="cuda")
    gen_valid = torch.arange(sg, device="cuda")[None, :] < gen_len[:, None]
    name = FOLD_NAMES[mode] + "_shared"
    before = _kernels.launches[name]
    got = fold_attend_layer(q, pc, seg, gc, gen_valid, fold_k=k,
                            shared_gen=True, candidates=(kc, vc))
    assert _kernels.launches[name] == before + 1
    assert torch.isfinite(got).all()
    _close(got, fold_attend_plain(q, pc, seg, gc, gen_valid, fold_k=k,
                                  shared_gen=True, candidates=(kc, vc)))
    # query 0 of the item with nothing else visible returns its own value
    g = h // kvh
    torch.testing.assert_close(
        got[2, 0].reshape(kvh, g, d).float(),
        vc[2, 0][:, None, :].expand(kvh, g, d).float(), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 12])
def test_auto_beam_route_decodes_any_beam_count(cuda, k):
    """beam_route="auto" (the default) takes the route auto_beam_route
    names, and a beam count K5 does not take (K > 8) goes to K4's beam
    mode instead of raising."""
    from halva_tpu_torch.ops.decode_attention import auto_beam_route

    b, h, sp, sg, d = 2, 8, 301, 128, 128
    pc, gc = _fold_caches(cuda, "bf16", b, b * k, h, sp, sg, d)
    q = torch.randn(b * k, 1, h, d, generator=cuda, device="cuda").bfloat16()
    seg = torch.ones(b, sp, dtype=torch.int32, device="cuda")
    gv = torch.ones(b * k, sg, dtype=torch.bool, device="cuda")
    route = auto_beam_route(pc, seg, k)
    name = "fold_attn" if route == "fold" else "decode_attn_beam"
    before = _kernels.launches[name]
    got = decode_attend_layer(q, pc, seg, gc, gv, beam_k=k)
    assert _kernels.launches[name] == before + 1
    _close(got, decode_attend_plain(q, pc, seg, gc, gv, beam_k=k))


@pytest.mark.cuda
def test_fold_attn_refuses_what_it_does_not_take(cuda):
    b, k, h, sp, sg, d = 2, 4, 8, 40, 128, 128
    q = torch.randn(b, k, h, d, generator=cuda, device="cuda").bfloat16()
    pc, gc = _fold_caches(cuda, "bf16", b, b * k, h, sp, sg, d)
    seg = torch.ones(b, sp, dtype=torch.int32, device="cuda")
    gv = torch.ones(b * k, sg, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="fold_k"):
        fold_attend_layer(q[:, :1], pc, seg, gc, gv[:b], fold_k=1)
    with pytest.raises(TypeError):
        fold_attend_layer(q.float(), pc, seg, gc, gv, fold_k=k)
    with pytest.raises(ValueError, match="unsupported shapes"):
        fold_attend_layer(q, pc, seg, gc, gv[:b], fold_k=k)
    with pytest.raises(ValueError, match="one CUDA device"):
        fold_attend_layer(q, pc, seg.cpu(), gc, gv, fold_k=k)


# name: (k, h, kvh, shared_gen): R = K*G = 4 (MHA, 4 beams), 8 (8 candidates),
# 16 (GQA G=4, 4 beams: Mistral's heads)
FOLD_SPLIT_CASES = {"mha_k4": (4, 8, 8, False), "shared_k8": (8, 8, 8, True),
                    "gqa_g4_k4": (4, 8, 2, False)}


def _fold_split_inputs(gen, mode, k, h, kvh, shared, items=3, sp=301, sg=128,
                       d=128):
    """K5's inputs for its key-axis split: an odd prompt length; item 0 with
    prompt tile [64, 128) masked; item 1 with an empty gen cache; the last
    item with no visible prompt or gen key (per-beam stage: its rows come
    out as 0); garbage in the scales of every masked key."""
    q = torch.randn(items, k, h, d, generator=gen, device="cuda").bfloat16()
    gen_rows = items if shared else items * k
    pc, gc = _fold_caches(gen, mode, items, gen_rows, kvh, sp, sg, d)
    seg = torch.ones(items, sp, dtype=torch.int32, device="cuda")
    seg[0, 64:128] = 0
    seg[0, 250:] = 0
    seg[-1] = 0
    steps = torch.randint(0, sg - k, (gen_rows,), generator=gen,
                          device="cuda")
    gen_valid = torch.arange(sg, device="cuda")[None, :] <= steps[:, None]
    per = gen_rows // items
    gen_valid[per:2 * per] = False
    gen_valid[-per:] = False
    cand = None
    if shared:
        cand = tuple(torch.randn(items, k, kvh, d, generator=gen,
                                 device="cuda").bfloat16() for _ in range(2))
    if mode != "bf16":
        dead = seg == 0
        if mode == "kv4":  # token t's scale sits at plane t % 2, row t // 2
            s2 = pc["v_scale"].shape[-1]
            dead = torch.nn.functional.pad(dead, (0, 2 * s2 - sp), value=True)
            dead = dead.reshape(items, s2, 2).permute(0, 2, 1)[:, :, None, :]
        else:
            dead = dead[:, None, :]
        pc["v_scale"][dead.expand_as(pc["v_scale"])] = float("nan")
        gc["v_scale"][~gen_valid[:, None, :].expand_as(gc["v_scale"])] = (
            float("inf"))
    return q, pc, seg, gc, gen_valid, cand


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [1, 2, 3, 5, None])
@pytest.mark.parametrize("case", list(FOLD_SPLIT_CASES))
@pytest.mark.parametrize("mode", ["bf16", "kv8", "kv4"])
def test_fold_attn_split_plans_match_plain(cuda, mode, case, forced):
    """K5 under forced plans (1, 2, 3 and 5 splits, and the SM count's) at
    R = 4, 8 and 16 rows a block, against fold_attend_split_plain under the
    same plan and against fold_attend_plain."""
    from halva_tpu_torch.ops.decode_attention import (
        fold_attend_split_plain, fold_plan, sm_count)

    k, h, kvh, shared = FOLD_SPLIT_CASES[case]
    q, pc, seg, gc, gv, cand = _fold_split_inputs(cuda, mode, k, h, kvh,
                                                  shared)
    items = q.shape[0]
    plan = fold_plan(items, kvh, k * h // kvh, h // kvh, seg.shape[1],
                     gv.shape[1], sm_count(q.device), shared, forced)
    name = FOLD_NAMES[mode] + ("_shared" if shared else "")
    before = _kernels.launches[name]
    got = fold_attend_layer(q, pc, seg, gc, gv, fold_k=k, shared_gen=shared,
                            candidates=cand, splits=forced)
    assert _kernels.launches[name] == before + 1
    assert torch.isfinite(got).all()
    want = fold_attend_plain(q, pc, seg, gc, gv, fold_k=k, shared_gen=shared,
                             candidates=cand)
    _close(got, want)
    _close(got, fold_attend_split_plain(q, pc, seg, gc, gv, k, plan,
                                        shared_gen=shared, candidates=cand))
    if not shared:  # the last item sees no key at all
        assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FOLD_SPLIT_CASES))
@pytest.mark.parametrize("mode", ["bf16", "kv4"])
def test_fold_attn_split_is_deterministic_and_graph_capturable(cuda, mode,
                                                               case):
    """Two K5 calls give the same bits (the splits merge in split order, no
    float atomics, the tickets are left at 0), one call captured in a CUDA
    graph and replayed gives the eager call's bits, and each call counts one
    launch."""
    k, h, kvh, shared = FOLD_SPLIT_CASES[case]
    q, pc, seg, gc, gv, cand = _fold_split_inputs(cuda, mode, k, h, kvh,
                                                  shared)
    name = FOLD_NAMES[mode] + ("_shared" if shared else "")

    def call():
        return fold_attend_layer(q, pc, seg, gc, gv, fold_k=k,
                                 shared_gen=shared, candidates=cand,
                                 splits=4)

    before = _kernels.launches[name]
    first, again = call(), call()
    assert _kernels.launches[name] == before + 2
    assert torch.equal(first, again)
    assert int(_kernels.tickets(q.device).abs().sum()) == 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


def _split_inputs(gen, mode, items, beam_k, h, kvh, sp=301, sg=128, d=128):
    """K4's inputs for its key-axis split: an odd prompt length (int4); item
    0 with prompt tile [64, 128) masked (a whole split of the finest plan
    sees no prompt key); item 1 with its gen cache all invalid; the last
    item with no visible key at all (it must come out as 0); garbage in
    the scales of every masked key."""
    rows = items * beam_k
    q = torch.randn(rows, 1, h, d, generator=gen, device="cuda").bfloat16()
    pc, gc = _fold_caches(gen, mode, items, rows, kvh, sp, sg, d)
    seg = torch.ones(items, sp, dtype=torch.int32, device="cuda")
    seg[0, 64:128] = 0
    seg[0, 250:] = 0
    seg[-1] = 0
    steps = torch.randint(0, sg, (rows,), generator=gen, device="cuda")
    gen_valid = torch.arange(sg, device="cuda")[None, :] <= steps[:, None]
    gen_valid[beam_k:2 * beam_k] = False
    gen_valid[-beam_k:] = False
    if mode != "bf16":
        dead = seg == 0
        if mode == "kv4":  # token t's scale sits at plane t % 2, row t // 2
            s2 = pc["v_scale"].shape[-1]
            dead = torch.nn.functional.pad(dead, (0, 2 * s2 - sp), value=True)
            dead = dead.reshape(items, s2, 2).permute(0, 2, 1)[:, :, None, :]
        else:
            dead = dead[:, None, :]
        pc["v_scale"][dead.expand_as(pc["v_scale"])] = float("nan")
        gc["v_scale"][~gen_valid[:, None, :].expand_as(gc["v_scale"])] = (
            float("inf"))
    return q, pc, seg, gc, gen_valid


def _split_check(got, want, split_want, beam_k):
    """Live rows against the plain versions, the dead item's rows exactly 0."""
    dead = slice(got.shape[0] - beam_k, None)
    assert torch.isfinite(got).all()
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    _close(got[:-beam_k], want[:-beam_k])
    _close(got, split_want)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [1, 2, None, 64])
@pytest.mark.parametrize("kvh", [8, 2])
@pytest.mark.parametrize("mode", ["bf16", "kv8", "kv4"])
def test_decode_attn_split_plans_match_plain(cuda, mode, kvh, forced):
    """K4 under forced plans (1 split, 2, the planned count, the most the
    prompt allows: one 64-key tile a split) at G = 1 and G = 4."""
    from halva_tpu_torch.ops.decode_attention import (
        decode_attend_split_plain, decode_plan, sm_count)

    items, h = 3, 8
    q, pc, seg, gc, gv = _split_inputs(cuda, mode, items, 1, h, kvh)
    plan = decode_plan(items, kvh, seg.shape[1], gv.shape[1],
                       sm_count(q.device), forced)
    name = {"bf16": "decode_attn"}.get(mode, "decode_attn_" + mode)
    before = _kernels.launches[name]
    got = decode_attend_layer(q, pc, seg, gc, gv, splits=forced)
    assert _kernels.launches[name] == before + 1
    _split_check(got, decode_attend_plain(q, pc, seg, gc, gv),
                 decode_attend_split_plain(q, pc, seg, gc, gv, plan), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [1, 2, 64])
@pytest.mark.parametrize("mode", ["bf16", "kv8", "kv4"])
def test_decode_attn_split_beam_mode_matches_plain(cuda, mode, forced):
    """K4's beam mode (4 beams an item, the grid route) under forced plans."""
    from halva_tpu_torch.ops.decode_attention import (
        decode_attend_split_plain, decode_plan, sm_count)

    items, k, h, kvh = 3, 4, 8, 2
    q, pc, seg, gc, gv = _split_inputs(cuda, mode, items, k, h, kvh)
    plan = decode_plan(items * k, kvh, seg.shape[1], gv.shape[1],
                       sm_count(q.device), forced)
    got = decode_attend_layer(q, pc, seg, gc, gv, beam_k=k,
                              beam_route="grid", splits=forced)
    _split_check(got, decode_attend_plain(q, pc, seg, gc, gv, beam_k=k),
                 decode_attend_split_plain(q, pc, seg, gc, gv, plan,
                                           beam_k=k), k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "kv4"])
def test_decode_attn_split_is_deterministic_and_graph_capturable(cuda, mode):
    """Two calls give the same bits (the splits merge in split order, no
    float atomics, the tickets are left at 0), and one call captured in a
    CUDA graph and replayed gives the eager call's bits."""
    q, pc, seg, gc, gv = _split_inputs(cuda, mode, 3, 1, 8, 8)
    first = decode_attend_layer(q, pc, seg, gc, gv, splits=4)
    again = decode_attend_layer(q, pc, seg, gc, gv, splits=4)
    assert torch.equal(first, again)
    assert int(_kernels.tickets(q.device).abs().sum()) == 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attend_layer(q, pc, seg, gc, gv, splits=4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attend_layer(q, pc, seg, gc, gv, splits=4)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


def _close_grad(got, want):
    want = want.float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=2e-2,
                               atol=2e-2 * scale)
    assert float((got.float() - want).norm() / want.norm()) <= 2e-3


def _bwd_inputs(gen, b, s, h, kvh, layout):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, do = r(b, s, h, 128), r(b, s, kvh, 128), r(b, s, kvh, 128), r(
        b, s, h, 128)
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[-1, s - 37:] = 0
    if layout == "packed":
        seg[0, 90:] = 2
    live = seg != 0
    do[~live] = 0  # dead rows never reach a loss
    return q, k, v, do, seg, live


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,causal,layout", [
    (8, True, "pad"), (8, False, "pad"), (2, True, "packed"),
    (8, True, "packed")])
def test_flash_bwd_matches_plain(cuda, kvh, causal, layout):
    b, s, h = 2, 200, 8
    q, k, v, do, seg, live = _bwd_inputs(cuda, b, s, h, kvh, layout)
    o, lse = flash_attention_fwd(q, k, v, seg, seg, causal=causal)
    before = (_kernels.launches["flash_bwd_dq"],
              _kernels.launches["flash_bwd_dkv"])
    got = flash_attention_bwd(q, k, v, seg, seg, o, lse, do, causal=causal)
    assert (_kernels.launches["flash_bwd_dq"],
            _kernels.launches["flash_bwd_dkv"]) == (before[0] + 1,
                                                    before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do,
                                     causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all()
        _close_grad(g[live], w[live])
    # the group sum runs inside K3, in a fixed order: bit-identical reruns
    again = flash_attention_bwd(q, k, v, seg, seg, o, lse, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_autograd_reaches_q_k_v(cuda):
    """On CUDA tensors flash_attention is an autograd Function: the grads of
    q, k and v exist (K1's output used to carry no grad_fn) and are K2's and
    K3's, which match the plain backward."""
    b, s, h, kvh = 2, 200, 8, 2
    q, k, v, do, seg, live = _bwd_inputs(cuda, b, s, h, kvh, "packed")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(_kernels.launches)
    out = flash_attention(*leaves, seg, seg)
    assert out.grad_fn is not None
    out.backward(do)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launches[name] == before.get(name, 0) + 1
    o, lse = flash_attention_fwd(q, k, v, seg, seg)
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do)
    for t, w in zip(leaves, want):
        assert t.grad is not None
        _close_grad(t.grad[live], w[live])


# K1, K2 and K3 in their modes: ALiBi, a window that bites (and one narrower
# than a tile, one that ends inside the first tile), window with GQA and
# packed segments, ALiBi with a window
FLASH_MODES = {
    "alibi": (8, "pad", {"alibi": True}),
    "alibi_gqa": (2, "packed", {"alibi": True}),
    "window": (8, "pad", {"sliding_window": 100}),
    "window_narrow": (8, "pad", {"sliding_window": 7}),
    "window_first_tile": (8, "pad", {"sliding_window": 40}),
    "window_gqa_packed": (2, "packed", {"sliding_window": 70}),
    "alibi_window": (2, "pad", {"alibi": True, "sliding_window": 90}),
}


def _mode_counters(modes):
    from halva_tpu_torch.ops.flash_attention import mode_suffix

    suffix = mode_suffix(modes.get("alibi", False),
                         modes.get("sliding_window"))
    return ["flash_fwd" + suffix, "flash_bwd_dq" + suffix,
            "flash_bwd_dkv" + suffix]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FLASH_MODES))
def test_flash_modes_match_plain(cuda, name):
    kvh, layout, modes = FLASH_MODES[name]
    b, s, h = 2, 333, 8
    q, k, v, do, seg, live = _bwd_inputs(cuda, b, s, h, kvh, layout)
    names = _mode_counters(modes)
    assert names[0] != "flash_fwd"
    before = [_kernels.launches[n] for n in names]
    o, lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
    got = flash_attention_bwd(q, k, v, seg, seg, o, lse, do, **modes)
    assert [_kernels.launches[n] for n in names] == [x + 1 for x in before]
    want_o = flash_attention_plain(q, k, v, seg, seg, **modes)
    _close(o[live], want_o[live])
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do, **modes)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close_grad(g[live], w[live])


@pytest.mark.cuda
@pytest.mark.parametrize("keys", BWD_DKV_KEYS)
@pytest.mark.parametrize("kvh,layout,modes", [
    (8, "pad", {}), (2, "packed", {"alibi": True}),
    (2, "pad", {"sliding_window": 70})])
def test_flash_bwd_dkv_layouts_match_plain(cuda, keys, kvh, layout, modes):
    """K3 under each layout the plan can choose (128 keys a block, or 64
    with the two warpgroups on alternate query tiles and their sums added
    in shared memory) matches the plain backward and repeats bit for bit."""
    b, s, h = 2, 333, 8
    q, k, v, do, seg, live = _bwd_inputs(cuda, b, s, h, kvh, layout)
    o, lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
    args = (q, k, v, seg, seg, do, lse, flash_attention_delta(o, do))
    got = flash_attention_bwd_dkv(*args, **modes, dkv_keys=keys)
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do, **modes)
    for g, w in zip(got, want[1:]):
        assert torch.isfinite(g).all()
        _close_grad(g[live], w[live])
    again = flash_attention_bwd_dkv(*args, **modes, dkv_keys=keys)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("modes,off,n", [
    ({}, 166, 167), ({}, 0, 64), ({}, 67, 100),
    ({"sliding_window": 90}, 166, 167), ({"alibi": True}, 200, 133)])
def test_flash_q_offset_equals_full_slice(cuda, modes, off, n):
    """A shard of the queries against all keys (Sq != Skv): o, LSE and dq
    equal the same rows of the full call, dk and dv those of the full call
    whose cotangent is zero outside the shard."""
    b, s, h, kvh = 2, 333, 8, 2
    q, k, v, do, seg, live = _bwd_inputs(cuda, b, s, h, kvh, "packed")
    full_o, full_lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
    do_full = torch.zeros_like(do)
    do_full[:, off:off + n] = do[:, off:off + n]
    full = flash_attention_bwd(q, k, v, seg, seg, full_o, full_lse, do_full,
                               **modes)
    qs, segs, dos = (t[:, off:off + n].contiguous() for t in (q, seg, do))
    names = _mode_counters({**modes, "q_offset": off})
    before = [_kernels.launches[x] for x in names]
    o, lse = flash_attention_fwd(qs, k, v, segs, seg, q_offset=off, **modes)
    got = flash_attention_bwd(qs, k, v, segs, seg, o, lse, dos, q_offset=off,
                              **modes)
    assert [_kernels.launches[x] for x in names] == [x + 1 for x in before]
    lv = segs != 0
    _close(o[lv], full_o[:, off:off + n][lv])
    torch.testing.assert_close(
        lse.transpose(1, 2)[lv], full_lse[:, :, off:off + n].transpose(1, 2)[lv],
        rtol=1e-4, atol=1e-4)
    _close_grad(got[0][lv], full[0][:, off:off + n][lv])
    _close_grad(got[1][live], full[1][live])
    _close_grad(got[2][live], full[2][live])
    want_o = flash_attention_plain(qs, k, v, segs, seg, q_offset=off, **modes)
    _close(o[lv], want_o[lv])


@pytest.mark.cuda
def test_flash_modes_autograd_and_refusals(cuda):
    b, s, h, kvh = 1, 200, 8, 2
    q, k, v, do, seg, live = _bwd_inputs(cuda, b, s, h, kvh, "pad")
    modes = {"alibi": True, "sliding_window": 64}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, seg, seg, **modes).backward(do)
    o, lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do, **modes)
    for t, w in zip(leaves, want):
        _close_grad(t.grad[live], w[live])
    q6 = torch.randn(1, 16, 6, 128, device="cuda").bfloat16()
    s16 = torch.ones(1, 16, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="power-of-two"):
        flash_attention_fwd(q6, q6, q6, s16, s16, alibi=True)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_fwd(q, k, v, seg, seg, alibi=True, causal=False)


def _gemm_close(got, want):
    want = want.float()
    diff = (got.float() - want).abs()
    limit = 1e-2 * (want.abs().max() / 4 + want.abs())
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= limit).all()), float((diff - limit).max())


def _w4_weights(gen, k, np_, groups):
    w = torch.randint(-128, 128, (k, np_), generator=gen, device="cuda",
                      dtype=torch.int8)  # every nibble, -8 included
    s = (torch.rand(2, groups, np_, generator=gen, device="cuda") * 0.02
         + 0.005).bfloat16()
    return w, s


# rows: the mma.sync path (up to 32), then the TMA + wgmma path: its first
# row (33), one m64 tile full (64), a 128-row tile one short of full (127)
# and one row into the next (129), batch 80, prefill (2492)
GEMM_ROWS = [9, 16, 32, 33, 64, 80, 127, 129, 300, 2492]


@pytest.mark.cuda
@pytest.mark.parametrize("k,np_,groups", [
    (4096, 2048, 1), (4096, 2048, 32), (4096, 5504, 32), (11008, 2048, 86),
    (4096, 512, 32), (14336, 2048, 112), (256, 72, 2),
    # N = 2080: not a multiple of the 256-channel tile, on the wgmma path
    (1024, 1040, 1), (1024, 1040, 8)])
@pytest.mark.parametrize("m", GEMM_ROWS)
def test_w4_gemm_matches_plain(cuda, m, k, np_, groups):
    w, s = _w4_weights(cuda, k, np_, groups)
    x = torch.randn(m, k, generator=cuda, device="cuda").bfloat16()
    before = _kernels.launches["w4_gemm"]
    got = w4_gemm(x, w, s)
    assert _kernels.launches["w4_gemm"] == before + 1
    assert got.shape == (m, 2 * np_) and got.dtype == torch.bfloat16
    _gemm_close(got, w4_gemm_plain(x, w, s))
    # the same function as K6, and the same bits from run to run (the split
    # reduction sums in split order)
    if m <= 80:
        _gemm_close(got, w4_dense_stacked(
            x, {"kernel_q4p": w, "kernel_scale4p": s}))
    assert torch.equal(got, w4_gemm(x, w, s))


@pytest.mark.cuda
def test_w4_gemm_large_m_leading_dims_and_dx(cuda):
    k, np_, groups = 4096, 2048, 32
    w, s = _w4_weights(cuda, k, np_, groups)
    x = torch.randn(2, 1087, k, generator=cuda, device="cuda").bfloat16()
    x.requires_grad_()
    y = w4_gemm(x, w, s)
    assert y.shape == (2, 1087, 2 * np_)
    _gemm_close(y, w4_gemm_plain(x.detach(), w, s))
    g = torch.randn(y.shape, generator=cuda, device="cuda").bfloat16()
    (dx,) = torch.autograd.grad(y, x, g)
    want = g @ dequantize_int4(w, s, torch.bfloat16).t()
    torch.testing.assert_close(dx, want, rtol=0, atol=0)
    assert not s.requires_grad and not w.is_floating_point()


@pytest.mark.cuda
def test_w4_gemm_refuses_what_it_does_not_take(cuda):
    w, s = _w4_weights(cuda, 256, 64, 1)
    x = torch.randn(4, 256, generator=cuda, device="cuda").bfloat16()
    with pytest.raises(TypeError):
        w4_gemm(x.float(), w, s)
    with pytest.raises(TypeError):
        w4_gemm(x, w, s.float())
    with pytest.raises(ValueError, match="unsupported shapes"):
        w4_gemm(x[:, :200].contiguous(), w[:200].contiguous(), s)  # K % 64
    with pytest.raises(ValueError, match="unsupported shapes"):
        w4_gemm(x, w[:, :60].contiguous(), s[:, :, :60].contiguous())
    w8, s8 = _w4_weights(cuda, 256, 64, 8)  # groups of 32 rows
    with pytest.raises(ValueError, match="unsupported shapes"):
        w4_gemm(x, w8, s8)
    with pytest.raises(ValueError, match="one CUDA device"):
        w4_gemm(x, w.cpu(), s)
    w2, s2 = _w4_weights(cuda, 256, 64, 2)  # groups of 128 rows: taken
    w4_gemm(x, w2, s2)
    with pytest.raises(ValueError, match="contiguous"):
        w4_gemm(x, w2, s2.transpose(0, 1).contiguous().transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096),
                                 (4096, 32000), (1024, 4096), (1024, 1024),
                                 (4096, 1024), (128, 72), (1024, 1040)])
@pytest.mark.parametrize("m", [4, 33, 64, 80, 127, 129, 577, 2492])
def test_int8_matmul_matches_plain(cuda, m, k, n):
    q = torch.randint(-127, 128, (k, n), generator=cuda, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand(1, n, generator=cuda, device="cuda") * 0.002
             + 0.0005).bfloat16()
    x = torch.randn(m, k, generator=cuda, device="cuda").bfloat16()
    before = _kernels.launches["int8_matmul"]
    got = int8_matmul(x, q, scale)
    assert _kernels.launches["int8_matmul"] == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _gemm_close(got, int8_matmul_plain(x, q, scale))
    assert torch.equal(got, int8_matmul(x, q, scale.reshape(-1)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [(0, 1), (1, 1), (1, 16)])
@pytest.mark.parametrize("m", [33, 80, 300])
def test_dq_gemm_plans_agree_and_repeat_bitwise(cuda, mode, groups, m):
    """K8 and K7 (per-channel and grouped scales) under forced plans: the
    wgmma path with 1, 3 and 5 K splits and the mma.sync path beside it
    agree with the plain version, and each split plan gives the same bits
    on every run (the last block sums the partials in split order)."""
    from halva_tpu_torch.ops.int8_matmul import (GemmPlan, TILE_K,
                                                 launch_dq_gemm, split_k)

    k, n = 2048, 2080  # N: not a multiple of the 256-channel tile
    if mode == 0:
        w = torch.randint(-127, 128, (k, n), generator=cuda, device="cuda",
                          dtype=torch.int8)
        s = (torch.rand(n, generator=cuda, device="cuda") * 0.002
             + 0.0005).bfloat16()
        want = int8_matmul_plain
    else:
        w, s = _w4_weights(cuda, k, n // 2, groups)
        want = w4_gemm_plain
    x = torch.randn(m, k, generator=cuda, device="cuda").bfloat16()
    plain = want(x, w, s)
    for path, bm in (("wgmma", 128), ("mma", 32)):
        for splits in (1, 3, 5):
            plan = GemmPlan(path, bm, *split_k(k // TILE_K, splits))
            got = launch_dq_gemm(mode, "plans", x, w, s, n, groups, plan)
            _gemm_close(got, plain)
            assert torch.equal(got, launch_dq_gemm(mode, "plans", x, w, s,
                                                   n, groups, plan))
    _kernels.launches.pop("plans")


@pytest.mark.cuda
def test_dq_gemm_stride_rule_runs_every_shape(cuda):
    """Weight rows that are no multiple of 16 bytes (TMA's stride rule) go
    to the 32-row tiles at any M; the wgmma path refuses them."""
    from halva_tpu_torch.ops.int8_matmul import GemmPlan, launch_dq_gemm

    k, n = 128, 72
    q = torch.randint(-127, 128, (k, n), generator=cuda, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand(n, generator=cuda, device="cuda") * 0.002
             + 0.0005).bfloat16()
    x = torch.randn(577, k, generator=cuda, device="cuda").bfloat16()
    _gemm_close(int8_matmul(x, q, scale), int8_matmul_plain(x, q, scale))
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch_dq_gemm(0, "plans", x, q, scale, n, 1,
                       GemmPlan("wgmma", 128, 1, 2))
    _kernels.launches.pop("plans", None)


@pytest.mark.cuda
def test_w8_dense_launches_k8_and_differentiates(cuda):
    k, n = 1024, 512
    q = torch.randint(-127, 128, (k, n), generator=cuda, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand(1, n, generator=cuda, device="cuda") * 0.002
             + 0.0005).bfloat16()
    x = torch.randn(3, 7, k, generator=cuda, device="cuda").bfloat16()
    x.requires_grad_()
    before = _kernels.launches["int8_matmul"]
    y = quant.w8_dense(x, q, scale)
    assert _kernels.launches["int8_matmul"] == before + 1
    _gemm_close(y, int8_matmul_plain(x.detach(), q, scale))
    g = torch.randn(y.shape, generator=cuda, device="cuda").bfloat16()
    (dx,) = torch.autograd.grad(y, x, g)
    want = g @ (q.bfloat16() * scale).t()
    torch.testing.assert_close(dx, want, rtol=0, atol=0)
    # W8A8 keeps the library product and the same backward
    y8 = quant.int8_dense(x, q, scale)
    assert _kernels.launches["int8_matmul"] == before + 1
    (dx8,) = torch.autograd.grad(y8, x, g)
    torch.testing.assert_close(dx8, want, rtol=0, atol=0)
    with pytest.raises(TypeError):
        int8_matmul(x.detach().float(), q, scale)
    with pytest.raises(ValueError, match="unsupported shapes"):
        int8_matmul(x.detach(), q[:, :500].contiguous(),
                    scale[:, :500].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["float", "int4"])
def test_head_dim_64_model_decodes_on_the_card_as_on_the_cpu(cuda, weights):
    """A config whose head dim the kernels do not take (64) runs on the card
    under attn_impl="auto" by the rule of ops/attention.kernel_route, with
    no kernel launch and no failure caught: greedy tokens equal its CPU
    run's (fp32 tree, full-fp32 matmuls on both devices)."""
    from halva_tpu_torch import tree
    from halva_tpu_torch.config import LlamaConfig, LlavaConfig, ViTConfig
    from halva_tpu_torch.ops.generate import generate_greedy
    from halva_tpu_torch.ops.w4_matmul import quantize_params_int4

    cfg = LlavaConfig(
        llm=LlamaConfig(vocab_size=512, hidden_size=128,
                        intermediate_size=256, num_layers=2, num_heads=2,
                        max_position_embeddings=256),
        vision=ViTConfig(image_size=28, patch_size=14, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=2))
    assert cfg.llm.head_size == 64
    params = tree.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32, device="cpu")
    if weights == "int4":
        params = quantize_params_int4(params, group_size=64)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(5, 500, (3, 12), generator=g, dtype=torch.int32)
    ids[:, 1] = -200
    images = torch.randn(3, 3, 28, 28, generator=g)
    lens = torch.tensor([12, 9, 11], dtype=torch.int32)
    ids[1, 9:] = 0
    ids[2, 11:] = 0
    kw = dict(max_new_tokens=6, eos_id=-1)
    with torch.inference_mode():
        want, want_n = generate_greedy(params, cfg, ids, images, lens, **kw)
        on_card = tree.map_tree(lambda t: t.cuda(), params)
        _kernels.reset_launches()
        got, got_n = generate_greedy(on_card, cfg, ids.cuda(), images.cuda(),
                                     lens.cuda(), **kw)
        assert sum(_kernels.launches.values()) == 0
        assert torch.equal(got.cpu(), want) and torch.equal(got_n.cpu(),
                                                            want_n)
        # a caller who names the kernel still gets the wrapper's refusal
        # (of the fp32 tensors, before it comes to their head dim)
        with pytest.raises((TypeError, ValueError)):
            generate_greedy(on_card, cfg, ids.cuda(), images.cuda(),
                            lens.cuda(), attn_impl="kernel", **kw)


# K1 on TMA + wgmma: query lengths that are no multiple of its 128-row
# blocks or its key tiles, GQA, against the whole-row plain version and the
# tiled plain version that walks K1's tiles (o within the bound above, LSE
# within 1e-3: an fp32 statistic summed in another order)
K1_SHAPES = [(1, 8), (64, 32), (127, 8), (129, 2), (623, 32), (623, 8)]


def _k1_inputs(gen, b, sq, skv, h, kvh):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v = r(b, sq, h, 128), r(b, skv, kvh, 128), r(b, skv, kvh, 128)
    kvseg = torch.ones(b, skv, dtype=torch.int32, device="cuda")
    if b > 1:
        kvseg[1, skv - skv // 5:] = 0  # a padded row
    qseg = kvseg[:, skv - sq:].contiguous()
    return q, k, v, qseg, kvseg


def _k1_check(o, lse, want, want_lse, qseg):
    from halva_tpu_torch.ops.flash_attention import M_INIT

    live = qseg != 0
    _close(o[live], want[live])
    lv = live[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lv], want_lse[lv], rtol=0, atol=1e-3)
    assert (o[~live] == 0).all()
    dead = lse[~lv]
    torch.testing.assert_close(
        dead, torch.full_like(dead, M_INIT * 0.6931471805599453), rtol=1e-6,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("sq,kvh", K1_SHAPES)
def test_flash_fwd_k1_matches_plain_and_tiled(cuda, sq, kvh, bk):
    from halva_tpu_torch.ops.flash_attention import flash_attention_tiled_plain

    q, k, v, qseg, kvseg = _k1_inputs(cuda, 2, sq, sq, 32, kvh)
    before = _kernels.launches["flash_fwd"]
    o, lse = flash_attention_fwd(q, k, v, qseg, kvseg, bk=bk)
    assert _kernels.launches["flash_fwd"] == before + 1
    want, want_lse = flash_attention_tiled_plain(q, k, v, qseg, kvseg,
                                                 bq=128, bk=128)
    _k1_check(o, lse, want, want_lse, qseg)
    live = qseg != 0
    _close(o[live], flash_attention_plain(q, k, v, qseg, kvseg)[live])


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("sq,skv,modes", [
    (100, 333, {}), (1, 400, {}), (167, 1087, {"sliding_window": 256}),
    (90, 300, {"alibi": True})])
def test_flash_fwd_k1_query_shard(cuda, sq, skv, modes, bk):
    """Sq != Skv: the last Sq positions of Skv keys, q_offset = Skv - Sq."""
    from halva_tpu_torch.ops.flash_attention import flash_attention_tiled_plain

    q, k, v, qseg, kvseg = _k1_inputs(cuda, 2, sq, skv, 8, 2)
    kw = dict(q_offset=skv - sq, **modes)
    o, lse = flash_attention_fwd(q, k, v, qseg, kvseg, bk=bk, **kw)
    want, want_lse = flash_attention_tiled_plain(q, k, v, qseg, kvseg,
                                                 bq=128, bk=128, **kw)
    _k1_check(o, lse, want, want_lse, qseg)


@pytest.mark.cuda
def test_flash_fwd_k1_long_windowed_row(cuda):
    """Mistral's long-row prefill: one 4,608-token row, H=32 over KVH=8,
    window 4096, on the plan's key tile (128 here) and on 64."""
    from halva_tpu_torch.ops.flash_attention import (
        flash_attention_tiled_plain,
        flash_fwd_plan,
    )

    n = 4608
    q, k, v, qseg, kvseg = _k1_inputs(cuda, 1, n, n, 32, 8)
    assert flash_fwd_plan(1, n, n, 32).bk == 128
    want, want_lse = flash_attention_tiled_plain(
        q, k, v, qseg, kvseg, sliding_window=4096, bq=128, bk=128)
    for bk in (None, 64):
        o, lse = flash_attention_fwd(q, k, v, qseg, kvseg, bk=bk,
                                     sliding_window=4096)
        _k1_check(o, lse, want, want_lse, qseg)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_k1_fully_masked_rows(cuda, causal):
    """A batch row that is padding throughout, and packed documents with
    gaps of padding between them: o = 0 and LSE = M_INIT * ln 2 there."""
    from halva_tpu_torch.ops.flash_attention import flash_attention_tiled_plain

    q, k, v, _, _ = _k1_inputs(cuda, 3, 700, 700, 8, 8)
    seg = torch.zeros(3, 700, dtype=torch.int32, device="cuda")
    seg[0, :200] = 1
    seg[0, 330:600] = 2
    seg[1, :641] = 7
    o, lse = flash_attention_fwd(q, k, v, seg, seg, causal=causal)
    want, want_lse = flash_attention_tiled_plain(q, k, v, seg, seg,
                                                 causal=causal, bq=128,
                                                 bk=128)
    _k1_check(o, lse, want, want_lse, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("modes", [{}, {"alibi": True},
                                   {"sliding_window": 256}])
def test_flash_fwd_k1_repeats_bitwise_and_replays_from_a_graph(cuda, modes):
    """No float atomics: two launches give the same bits, and a CUDA graph
    that captured the launch replays it on new inputs copied into the
    captured tensors, bit for bit as an eager launch on them."""
    q, k, v, qseg, kvseg = _k1_inputs(cuda, 2, 623, 623, 32, 8)
    o1, l1 = flash_attention_fwd(q, k, v, qseg, kvseg, **modes)
    o2, l2 = flash_attention_fwd(q, k, v, qseg, kvseg, **modes)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_fwd(q, k, v, qseg, kvseg, **modes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        og, lg = flash_attention_fwd(q, k, v, qseg, kvseg, **modes)
    nq, nk, nv, _, _ = _k1_inputs(cuda, 2, 623, 623, 32, 8)
    q.copy_(nq)
    k.copy_(nk)
    v.copy_(nv)
    graph.replay()
    torch.cuda.synchronize()
    o3, l3 = flash_attention_fwd(q, k, v, qseg, kvseg, **modes)
    assert not torch.equal(o3, o1)
    assert torch.equal(og, o3) and torch.equal(lg, l3)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 80])
def test_w4_decode_matmul_group32_takes_k6_above_8_rows(cuda, rows):
    """A tree packed with group_size=32 (groups K7 refuses) above 8 rows:
    `w4_route` sends it to K6, which matches its plain version; it used to
    raise in K7's wrapper."""
    from halva_tpu_torch.ops.w4_matmul import (
        quantize_kernel_int4_stacked,
        w4_decode_matmul,
    )

    w = torch.randn(1, 4096, 2048, generator=cuda, device="cuda") * 0.02
    packed = quantize_kernel_int4_stacked(w, group_size=32)
    p = {name: t[0].contiguous() for name, t in packed.items()}
    x = torch.randn(rows, 4096, generator=cuda, device="cuda").bfloat16()
    before = dict(_kernels.launches)
    got = w4_decode_matmul(x, p)
    assert _kernels.launches["w4_gemv"] == before.get("w4_gemv", 0) + 1
    assert _kernels.launches["w4_gemm"] == before.get("w4_gemm", 0)
    _gemm_close(got, w4_dense_stacked_plain(x, p))


@pytest.mark.cuda
def test_w8_dense_fp32_x_is_the_references_expression(cuda):
    """fp32 x (K8 takes bf16 only): the reference's x @ (q * scale) in x's
    dtype, no launch; it used to raise in K8's wrapper."""
    p = quant.quantize_kernel(
        torch.randn(1024, 512, generator=cuda, device="cuda") * 0.05)
    x = torch.randn(7, 1024, generator=cuda, device="cuda")
    before = sum(_kernels.launches.values())
    got = quant.w8_dense(x, p["kernel_q"], p["kernel_scale"])
    assert sum(_kernels.launches.values()) == before
    want = x @ (p["kernel_q"].float() * p["kernel_scale"].float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_encode_images_int8_fp32_tree_on_the_card_as_on_the_cpu(
        cuda, monkeypatch):
    """The CLIP tower of an fp32 tree quantized to int8 with W8A8 off runs
    every quantized dense in fp32 through the reference's expression on the
    card (its first dense used to raise), as on the CPU: full-fp32 matmuls
    and convolutions on both devices, fp32 summation orders apart."""
    from halva_tpu_torch import tree
    from halva_tpu_torch.config import LlamaConfig, LlavaConfig, ViTConfig
    from halva_tpu_torch.models.llava import encode_images

    monkeypatch.setattr(quant, "_W8A8", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = LlavaConfig(
        llm=LlamaConfig(vocab_size=512, hidden_size=128,
                        intermediate_size=256, num_layers=1, num_heads=1,
                        max_position_embeddings=256),
        vision=ViTConfig(image_size=56, patch_size=14, hidden_size=128,
                         intermediate_size=256, num_layers=2, num_heads=2))
    params = quant.quantize_params(tree.init_params(
        cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu"))
    images = torch.randn(2, 3, 56, 56, generator=torch.Generator()
                         .manual_seed(1))
    want = encode_images(params, cfg, images)
    on_card = tree.map_tree(lambda t: t.cuda(), params)
    before = sum(_kernels.launches.values())
    got = encode_images(on_card, cfg, images.cuda())
    assert sum(_kernels.launches.values()) == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# The decode-row loop (csrc/dq_rows.cuh): K6, and K7 / K8 up to 32 rows.
# Against the plain version (the bound above) and against the loop's own
# arithmetic in torch ops, the split plain versions, which round as the
# kernel does and sum in its order up to the tensor cores' order within a
# range: one bf16 step of the output either way, |got - split| <= 2^-7
# |split| + 2^-10 max|split|.
def _split_close(got, want):
    want = want.float()
    diff = (got.float() - want).abs()
    limit = 2**-7 * want.abs() + 2**-10 * want.abs().max()
    assert bool((diff <= limit).all()), float((diff - limit).max())


# (K, N/2, G): the 7B shapes with per-channel scales, groups of 128 rows and
# (down) groups of 344 rows, no multiple of the 32-row tile; N/2 = 8 x 171
K6_SHAPES = [(4096, 2048, 1), (4096, 2048, 32), (4096, 5504, 1),
             (4096, 5504, 32), (11008, 2048, 1), (11008, 2048, 86),
             (11008, 2048, 32), (4096, 1368, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,np_,groups", K6_SHAPES)
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, 7, 8, 80])
def test_k6_matches_plain_and_its_split_version(cuda, b, k, np_, groups):
    from halva_tpu_torch.ops.w4_matmul import w4_dense_stacked_split_plain

    w, s = _w4_weights(cuda, k, np_, groups)
    x = torch.randn(b, k, generator=cuda, device="cuda").bfloat16()
    p = {"kernel_q4p": w, "kernel_scale4p": s}
    before = _kernels.launches["w4_gemv"]
    got = w4_dense_stacked(x, p)
    assert _kernels.launches["w4_gemv"] == before + 1
    assert got.shape == (b, 2 * np_) and got.dtype == torch.bfloat16
    _gemm_close(got, w4_dense_stacked_plain(x, p))
    _split_close(got, w4_dense_stacked_split_plain(x, p))


DQ_ROWS = [1, 4, 8, 9, 16, 17, 31, 32]


def _dq_operands(gen, mode, k, n, groups):
    """mode 0: K8 (int8 q, (N,) scales); 1: K7 (packed int4, G groups)."""
    if mode == 0:
        q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = (torch.rand(n, generator=gen, device="cuda") * 0.002
             + 0.0005).bfloat16()
        return q, s
    return _w4_weights(gen, k, n // 2, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [(0, 1), (1, 1), (1, 32)])
@pytest.mark.parametrize("m", DQ_ROWS)
def test_dq_rows_path_matches_plain_and_its_split_version(cuda, m, mode,
                                                          groups):
    """Up to 32 rows K7 and K8 run the decode-row loop ('mma' plans, row
    tiles of 8, 16 or 32) in each of their three modes."""
    from halva_tpu_torch.ops.int8_matmul import (gemm_plan,
                                                 int8_matmul_split_plain,
                                                 row_chunk)
    from halva_tpu_torch.ops.w4_matmul import w4_gemm_split_plain

    k, n = 4096, 11008
    w, s = _dq_operands(cuda, mode, k, n, groups)
    x = torch.randn(m, k, generator=cuda, device="cuda").bfloat16()
    plan = gemm_plan(m, k, n, w.shape[-1])
    assert plan.path == "mma" and plan.bm == row_chunk(m)
    name = "int8_matmul" if mode == 0 else "w4_gemm"
    before = _kernels.launches[name]
    if mode == 0:
        got = int8_matmul(x, w, s)
        plain, split = int8_matmul_plain(x, w, s), int8_matmul_split_plain(
            x, w, s)
    else:
        got = w4_gemm(x, w, s)
        plain, split = w4_gemm_plain(x, w, s), w4_gemm_split_plain(x, w, s)
    assert _kernels.launches[name] == before + 1
    _gemm_close(got, plain)
    _split_close(got, split)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [(0, 1), (1, 1), (1, 2)])
def test_dq_rows_path_takes_the_stride_rule_shapes_at_577_rows(cuda, mode,
                                                               groups):
    """Weight rows that are no multiple of 16 bytes (N = 72 int8 bytes, N/2
    = 72 packed bytes): the decode-row loop in 32-row chunks, 8-byte
    copies."""
    from halva_tpu_torch.ops.int8_matmul import gemm_plan

    k, n = 256, 72 if mode == 0 else 144
    w, s = _dq_operands(cuda, mode, k, n, groups)
    x = torch.randn(577, k, generator=cuda, device="cuda").bfloat16()
    assert gemm_plan(577, k, n, w.shape[-1])[:2] == ("mma", 32)
    if mode == 0:
        _gemm_close(int8_matmul(x, w, s), int8_matmul_plain(x, w, s))
    else:
        _gemm_close(w4_gemm(x, w, s), w4_gemm_plain(x, w, s))


def _replays(launch, refill):
    """launch() twice (the same bits: the split merge sums in split order),
    then from a CUDA graph after refill() wrote new inputs in place: the
    same bits as an eager launch on them."""
    one, two = launch(), launch()
    assert torch.equal(one, two)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch()
    refill()
    graph.replay()
    torch.cuda.synchronize()
    eager = launch()
    assert not torch.equal(eager, one)
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [1, 2, 3, 8])
@pytest.mark.parametrize("b,groups", [(4, 32), (4, 1), (16, 32), (80, 128)])
def test_k6_forced_plans_agree_repeat_and_replay(cuda, b, groups, forced):
    from halva_tpu_torch.ops.w4_matmul import (K_TILE, plan,
                                               w4_dense_stacked_split_plain)

    k, np_ = 4096, 5504
    w, s = _w4_weights(cuda, k, np_, groups)
    x = torch.randn(b, k, generator=cuda, device="cuda").bfloat16()
    p = {"kernel_q4p": w, "kernel_scale4p": s}
    rc, _, _ = plan(b, k, np_, groups)
    kt = k // K_TILE
    tps = -(-kt // forced)
    forced_plan = (rc, -(-kt // tps), tps * K_TILE)
    want = w4_dense_stacked_split_plain(x, p, forced_plan)
    _split_close(w4_dense_stacked(x, p, forced_plan), want)

    def refill():
        x.copy_(torch.randn(b, k, generator=cuda, device="cuda"))

    _replays(lambda: w4_dense_stacked(x, p, forced_plan), refill)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,groups", [(0, 1), (1, 1), (1, 32)])
@pytest.mark.parametrize("m,splits", [(4, 1), (4, 3), (16, 2), (32, 5)])
def test_dq_rows_forced_plans_agree_repeat_and_replay(cuda, mode, groups, m,
                                                      splits):
    from halva_tpu_torch.ops.int8_matmul import (TILE_K, gemm_plan,
                                                 int8_matmul_split_plain,
                                                 launch_dq_gemm, split_k)
    from halva_tpu_torch.ops.w4_matmul import w4_gemm_split_plain

    k, n = 4096, 4096
    w, s = _dq_operands(cuda, mode, k, n, groups)
    x = torch.randn(m, k, generator=cuda, device="cuda").bfloat16()
    plan = gemm_plan(m, k, n, w.shape[-1])
    plan = plan._replace(**dict(zip(("splits", "tps"),
                                    split_k(k // TILE_K, splits))))
    split = (int8_matmul_split_plain if mode == 0 else w4_gemm_split_plain)
    _split_close(launch_dq_gemm(mode, "plans", x, w, s, n, groups, plan),
                 split(x, w, s, plan))

    def refill():
        x.copy_(torch.randn(m, k, generator=cuda, device="cuda"))

    _replays(lambda: launch_dq_gemm(mode, "plans", x, w, s, n, groups, plan),
             refill)
    _kernels.launches.pop("plans")
