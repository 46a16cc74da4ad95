"""K5's key-axis split on the CPU: its plan and its plain version.

`fold_attend_split_plain` (the splits and the merge K5 computes, in plain
ops) under forced plans of 1, 2, 3 and 5 splits and the plan `fold_plan`
makes for 132 SMs, against the reference's Pallas `fold_attend_layer` run
directly (interpret mode on the CPU), on the seeded numpy inputs of
`test_torch_fold_attention.py`: both stages, bf16, int8 and int4 prompt
caches, GQA (up to 32 rows an item: two chunks), a dead prompt and an item
with no visible key. Then the properties of `fold_plan` itself, and the
`"auto"` beam route as a function of the shapes alone.

Tolerances as in `test_torch_fold_attention.py`: fp32 queries 1e-5
relative / 1e-4 absolute (sum order only); bf16 queries 2e-2 absolute.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.ops.decode_attention import fold_attend_layer as jax_fold
from halva_tpu_torch import tree
from halva_tpu_torch.ops.decode_attention import (
    FOLD_ROWS,
    TILE,
    FoldPlan,
    auto_beam_route,
    fold_attend_plain,
    fold_attend_split_plain,
    fold_plan,
    fold_split_ranges,
)
from test_torch_fold_attention import (
    BEAM_CASES,
    SHARED_CASES,
    _inputs,
    _layer,
    _tol,
)

torch.set_num_threads(2)

SMS = 132  # an H100's SMs
PLANS = [1, 2, 3, 5, "sms"]  # forced aims, and the SM count's


@functools.lru_cache(maxsize=None)
def _case(name, fmt, q_dtype, shared):
    """The torch inputs of one case and the reference's output (computed
    once per case: the interpret-mode kernel is the slow part)."""
    k, h, kvh, sp, sg, dead = (SHARED_CASES if shared else BEAM_CASES)[name]
    jdt = jnp.float32 if q_dtype == "f32" else jnp.bfloat16
    q, prompt, seg, gen, gv, cand = _inputs(fmt, k, h, kvh, sp, sg, shared,
                                            jdt, dead)
    li = 1
    kw = {}
    tcand = None
    if shared:
        kw = dict(shared_gen=True, candidates=tuple(
            jnp.asarray(c).astype(jdt) for c in cand))
        tcand = tuple(tree.to_torch(list(cand), device="cpu"))
        if q_dtype == "f32":  # candidates arrive in the queries' type
            tcand = tuple(t.float() for t in tcand)
    want = np.asarray(jax_fold(
        jnp.asarray(q), jax.tree.map(jnp.asarray, prompt), jnp.asarray(seg),
        jax.tree.map(jnp.asarray, gen), jnp.asarray(gv), jnp.int32(li),
        fold_k=k, **kw), np.float32)
    tq, tseg, tgv = tree.to_torch([q, seg, gv], device="cpu")
    args = (tq, _layer(tree.to_torch(prompt, device="cpu"), li), tseg,
            _layer(tree.to_torch(gen, device="cpu"), li), tgv)
    return args, tcand, want, (k, h, kvh, sp, sg, dead)


def _plan(forced, items, k, h, kvh, sp, sg, shared):
    return fold_plan(items, kvh, k * (h // kvh), h // kvh, sp, sg, SMS,
                     shared, None if forced == "sms" else forced)


@pytest.mark.parametrize("forced", PLANS)
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("name", list(BEAM_CASES))
def test_split_plain_per_beam_matches_reference(name, fmt, q_dtype, forced):
    args, _, want, (k, h, kvh, sp, sg, dead) = _case(name, fmt, q_dtype,
                                                     False)
    plan = _plan(forced, args[0].shape[0], k, h, kvh, sp, sg, False)
    got = fold_attend_split_plain(*args, k, plan)
    assert got.dtype == args[0].dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(q_dtype))
    if dead == "all":  # item 1 sees no key: 0, as the kernels give
        assert not got[1].any() and not want[1].any()
    torch.testing.assert_close(
        got.float(), fold_attend_plain(*args, k).float(),
        **(dict(rtol=1e-5, atol=1e-5) if q_dtype == "f32"
           else dict(rtol=0, atol=2e-2)))


@pytest.mark.parametrize("forced", PLANS)
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("name", list(SHARED_CASES))
def test_split_plain_shared_gen_matches_reference(name, fmt, q_dtype,
                                                  forced):
    args, cand, want, (k, h, kvh, sp, sg, _) = _case(name, fmt, q_dtype,
                                                     True)
    plan = _plan(forced, args[0].shape[0], k, h, kvh, sp, sg, True)
    got = fold_attend_split_plain(*args, k, plan, shared_gen=True,
                                  candidates=cand)
    assert got.dtype == args[0].dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(q_dtype))


# (items, kvh, k, g, sp, sg, shared, forced)
PLAN_SHAPES = [
    (4, 32, 4, 1, 623, 128, False, None),  # llava-1.5-7b, 4 beams
    (4, 32, 4, 1, 623, 128, True, None),   # a verify step, draft_k 4
    (4, 32, 8, 1, 623, 256, True, None),   # draft_k 8
    (4, 8, 4, 4, 623, 128, False, None),   # Mistral's GQA, 16 rows
    (4, 8, 8, 4, 623, 128, True, 3),       # 32 rows: two chunks
    (2, 4, 5, 8, 301, 16, False, 4),       # 40 rows, a partial last chunk
    (2, 4, 3, 2, 64, 8, False, 5),         # one prompt tile
    (3, 2, 2, 1, 130, 0, False, 2),        # no gen span
    (80, 32, 4, 1, 623, 128, False, None),  # batch 80
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_fold_plan_covers_each_key_once(shape):
    """Every prompt tile in exactly one split, boundaries on 64-token tiles
    (even tokens for int4), no empty prompt split, each beam's gen span in
    one split (a split of its own when the gen spans have splits), the
    candidates once, and no split without keys but a beam slot past the
    last beam of a partial last chunk."""
    items, kvh, k, g, sp, sg, shared, forced = shape
    plan = fold_plan(items, kvh, k * g, g, sp, sg, SMS, shared, forced)
    assert plan.chunks == -(-k * g // FOLD_ROWS)
    ranges = fold_split_ranges(plan, sp, sg, k, shared)
    assert len(ranges) == plan.chunks
    prompt_tiles = -(-sp // TILE)
    for c, chunk in enumerate(ranges):
        assert len(chunk) == plan.splits
        beams = list(range(c * plan.beams, min(k, (c + 1) * plan.beams)))
        covered = [t for split in chunk for r in split if r[0] == "prompt"
                   for t in range(r[1], r[2])]
        assert covered == list(range(sp))
        for split in chunk:
            for r in split:
                if r[0] == "prompt":
                    assert r[1] % TILE == 0 and r[1] % 2 == 0
                    assert r[2] == sp or r[2] % TILE == 0
        gens = [(z, r[1]) for z, split in enumerate(chunk) for r in split
                if r[0] == "gen"]
        if sg:
            assert sorted(j for _, j in gens) == (
                [None] if shared else beams)
        else:
            assert gens == []
        cands = [z for z, split in enumerate(chunk) for r in split
                 if r[0] == "cand"]
        assert cands == ([plan.splits - 1] if shared else [])
        if plan.gsplits and not shared:
            for z, j in gens:
                assert chunk[z] == [("gen", j, 0, sg)]
        empty = [z for z, split in enumerate(chunk) if not split]
        assert all(z >= plan.psplits + len(beams) for z in empty)
        assert plan.psplits * plan.tps >= prompt_tiles


def test_fold_plan_values():
    """One split where the work items fill the card (batch 80, 2,560 blocks
    of 16 rows), and the plans at the 7B shapes of the beam and verify
    steps."""
    assert fold_plan(80, 32, 4, 1, 623, 128, SMS, False).splits == 1
    assert fold_plan(80, 32, 4, 1, 623, 128, SMS, True).splits == 1
    # 128 work items: 3 prompt splits of 4 tiles, a split per beam
    assert fold_plan(4, 32, 4, 1, 623, 128, SMS, False) == FoldPlan(
        1, 4, 3, 4, 4)
    assert fold_plan(4, 32, 4, 1, 623, 128, SMS, True) == FoldPlan(
        1, 4, 3, 4, 1)
    # Mistral: 32 work items of 16 rows, 5 prompt splits of 2 tiles
    assert fold_plan(4, 8, 16, 4, 623, 128, SMS, False) == FoldPlan(
        1, 4, 5, 2, 4)
    assert fold_plan(4, 32, 4, 1, 623, 128, SMS, False, splits=1) == (
        FoldPlan(1, 4, 1, 10, 0))
    with pytest.raises(ValueError, match="splits"):
        fold_plan(4, 32, 4, 1, 623, 128, SMS, False, splits=0)


def _prompt_meta(mode, items, kvh=32, sp=623, d=128):
    """A prompt cache and segment ids of these shapes on the meta device:
    the route reads shapes only."""
    def t(*shape, dtype=torch.int8):
        return torch.empty(shape, dtype=dtype, device="meta")

    if mode == "bf16":
        pc = {"k": t(items, kvh, sp, d, dtype=torch.bfloat16),
              "v": t(items, kvh, sp, d, dtype=torch.bfloat16)}
    elif mode == "kv8":
        pc = {"k": t(items, kvh, sp, d), "v": t(items, kvh, sp, d),
              "k_scale": t(items, kvh, sp, dtype=torch.bfloat16),
              "v_scale": t(items, kvh, sp, dtype=torch.bfloat16)}
    else:
        s2 = -(-sp // 2)
        pc = {"k4": t(items, kvh, s2, d), "v4": t(items, kvh, s2, d),
              "k_scale": t(items, 2, kvh, s2, dtype=torch.bfloat16),
              "v_scale": t(items, 2, kvh, s2, dtype=torch.bfloat16)}
    return pc, t(items, sp, dtype=torch.int32)


@pytest.mark.parametrize("k", [1, 9, 12, 16])
def test_auto_beam_route_takes_k4_outside_k5s_beam_counts(k):
    assert auto_beam_route(*_prompt_meta("bf16", 4), k) == "grid"


# (items, kv heads, format): the route measured faster on an H100 at
# llava-1.5-7b's Sp=623, 4 beams (chip_smoke.py --fold-only)
AUTO_ROUTES = {
    (4, 32, "bf16"): "fold",
    (4, 32, "kv8"): "grid",
    (4, 32, "kv4"): "grid",
    (4, 8, "bf16"): "grid",  # a tie: K5 0.0294 ms, K4's beam mode 0.0300
    (80, 32, "bf16"): "fold",
    (80, 32, "kv8"): "fold",
    (80, 32, "kv4"): "fold",
}


@pytest.mark.parametrize("shape", list(AUTO_ROUTES))
def test_auto_beam_route_is_the_measured_faster_route(shape):
    items, kvh, mode = shape
    pc, seg = _prompt_meta(mode, items, kvh=kvh)
    assert auto_beam_route(pc, seg, 4) == AUTO_ROUTES[shape]
