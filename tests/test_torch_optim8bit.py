"""The port's 8-bit Adam moments (halva_tpu_torch/train/optim8bit.py and
trainer.DPAOptimizer(optim="adamw8bit")) against the reference's
halva_tpu/train/optim8bit.py (`scale_by_adam8bit`) and its optax chain, on
the CPU, from the same seeded numpy params and grads.

- After N updates from the same grads, the int8 / uint8 codes equal the
  reference's, except for at most one code step where the pre-rounding
  value lies at a rounding midpoint (within 1e-4 of one: the two
  frameworks' last-bit differences decide it); the scales and the updates
  match within rtol 1e-6 (atol 1e-9). One update from the same state
  (state_from_reference) gives the same codes.
- Leaves under min_quant_size keep fp32 moments; leaves whose size is no
  multiple of the block are padded as in the reference.
- It tracks fp32 Adam on the quadratic of tests/test_optim8bit.py:44 (the
  same bounds); a param without a grad is passed over (the reference's None
  placeholders); the state takes ~2 bytes a param.
- DPAOptimizer(optim="adamw8bit") equals the reference's optax chain (clip,
  8-bit moments, decayed weights, schedule, MultiSteps) over two updates:
  on a tree of quantized and small leaves (rtol 1e-6), and through the
  LLAVA_TINY train step from a perturbed lora_b (the first update applies
  lr(0) = 0; every param within lr / 10, the bound of
  tests/test_torch_trainer.py's four micro-steps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from halva_tpu.train import optim8bit as joptim8bit
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import tree
from halva_tpu_torch.train import optim8bit, trainer

torch.set_num_threads(2)

B1, B2, EPS = 0.9, 0.999, 1e-8


def _ref_run(shapes, grads, min_quant_size=4096):
    """The reference's transform over the grads; its states after each."""
    tx = joptim8bit.scale_by_adam8bit(min_quant_size=min_quant_size)
    params = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    st = tx.init(params)
    out = []
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st)
        out.append((jax.tree.map(np.asarray, upd),
                    jax.tree.map(np.asarray, st.mu), int(st.count)))
    return out


def _port_run(shapes, grads, min_quant_size=4096):
    states = {k: optim8bit.init_state(torch.zeros(s), min_quant_size=
                                      min_quant_size)
              for k, s in shapes.items()}
    out = []
    for n, g in enumerate(grads, 1):
        upd = {k: optim8bit.adam_direction(torch.from_numpy(v), states[k],
                                           B1, B2, EPS, n).numpy()
               for k, v in g.items()}
        out.append((upd, {k: {n_: t.numpy().copy() for n_, t in st.items()}
                          for k, st in states.items()}, n))
    return out


def _grads(shapes, n, seed=0):
    rng = np.random.RandomState(seed)
    return [{k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 0)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(n)]


SHAPES = {"big": (64, 128), "ragged": (33, 200), "small": (8, 16)}


def _codes_close(got, want, x, what):
    """Codes equal, or one step apart where x (the pre-rounding value)
    lies at a rounding midpoint."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    diff = got != want
    assert np.abs(got - want).max(initial=0) <= 1, what
    frac = np.abs(x - np.floor(x) - 0.5)
    assert (frac[diff] < 1e-4).all(), (what, int(diff.sum()))


def test_codes_scales_and_updates_equal_the_references():
    grads = _grads(SHAPES, 6)
    want = _ref_run(SHAPES, grads)
    got = _port_run(SHAPES, grads)
    assert set(got[-1][1]["small"]) == {"m", "v"}
    assert set(got[-1][1]["big"]) == set(optim8bit.QUANTIZED)
    for (gu, gs, gn), (wu, ws, wn) in zip(got, want):
        assert gn == wn
        for k in SHAPES:
            np.testing.assert_allclose(gu[k], wu[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)
            for name in ws[k]:
                a, b = gs[k][name], ws[k][name]
                assert a.dtype == b.dtype and a.shape == b.shape, (k, name)
                if name in ("m_q", "v_q"):
                    # the trajectory: one code step at most, and rarely
                    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, name)
                    continue
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12,
                                           err_msg=f"{k} {name}")
    # codes after the last update, checked against the port's fp32 moments
    # before rounding (one step from the reference's state)
    _, ws, count = want[-2]
    for k in ("big", "ragged"):
        st = optim8bit.state_from_reference(ws[k], count, device="cpu")
        g = torch.from_numpy(grads[-1][k])
        flat = torch.nn.functional.pad(g.reshape(-1), (
            0, (-g.numel()) % optim8bit.BLOCK))
        m = B1 * optim8bit._dequantize_signed(st["m_q"], st["m_s"]) + (
            1 - B1) * flat
        v = B2 * optim8bit._dequantize_sqrt(st["v_q"], st["v_s"]) + (
            1 - B2) * flat * flat
        optim8bit.adam_direction(g, st, B1, B2, EPS, count + 1)
        last = want[-1][1][k]
        xm = (m.reshape(-1, optim8bit.BLOCK) / st["m_s"]).numpy()
        xv = (v.sqrt().reshape(-1, optim8bit.BLOCK) / st["v_s"]).numpy()
        _codes_close(st["m_q"].numpy(), last["m_q"], xm, f"{k} m")
        _codes_close(st["v_q"].numpy(), last["v_q"], xv, f"{k} v")


def test_state_round_trips_through_the_references_leaves():
    grads = _grads(SHAPES, 3, seed=4)
    want = _ref_run(SHAPES, grads)
    _, ws, count = want[-1]
    for k in SHAPES:
        st = optim8bit.state_from_reference(ws[k], count, device="cpu")
        back, n = optim8bit.state_to_reference(st)
        assert n == count and set(back) == set(ws[k])
        for name in back:
            assert back[name].dtype == ws[k][name].dtype
            assert np.array_equal(back[name], ws[k][name])


def test_small_leaf_threshold_follows_min_quant_size():
    p = torch.zeros(64, 64)  # 4096 elements
    assert set(optim8bit.init_state(p)) == set(optim8bit.QUANTIZED)
    assert set(optim8bit.init_state(p, min_quant_size=4097)) == {"m", "v"}
    st = optim8bit.init_state(torch.zeros(300, 1))
    assert set(st) == {"m", "v"} and st["m"].dtype == torch.float32
    big = optim8bit.init_state(torch.zeros(33, 200))
    assert big["m_q"].shape == (26, 256) and big["v_s"].shape == (26, 1)


def test_tracks_fp32_adam_on_quadratic():
    """tests/test_optim8bit.py:44 in the port: minimize ||Wx - y||^2 for
    150 steps at lr 1e-2 with 8-bit and fp32 moments."""
    rng = np.random.RandomState(0)
    w0 = torch.from_numpy(rng.randn(32, 256).astype(np.float32))
    x = torch.from_numpy(rng.randn(256, 16).astype(np.float32))
    y = torch.from_numpy(rng.randn(32, 16).astype(np.float32))

    def run(opt_cls, **kw):
        w = w0.clone().requires_grad_(True)
        opt = opt_cls([w], lr=1e-2, betas=(B1, B2), eps=EPS,
                      weight_decay=0.0, **kw)
        losses = []
        for _ in range(150):
            loss = ((w @ x - y) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(((w.detach() @ x - y) ** 2).mean()))
        return w.detach(), losses

    w8, l8 = run(optim8bit.AdamW8bit, min_quant_size=1024)
    wf, lf = run(torch.optim.AdamW)
    assert l8[-1] < 0.25 * l8[0]
    assert abs(l8[-1] - lf[-1]) < 0.15 * (l8[0] - lf[-1])
    assert float((w8 - wf).norm() / wf.norm()) < 0.2


def test_params_without_grads_pass_through():
    a = torch.ones(4096, requires_grad=True)
    b = torch.ones(10, requires_grad=True)
    opt = optim8bit.AdamW8bit([a, b], lr=0.1)
    a.grad = torch.full((4096,), 0.1)
    opt.step()
    assert b not in opt.state and torch.equal(b.detach(), torch.ones(10))
    assert int(opt.state[a]["step"]) == 1
    assert float(a.detach().max()) < 1.0
    nbytes = optim8bit.state_bytes(opt)
    assert nbytes < 2.1 * a.numel() + 1024  # vs 8 bytes a param in fp32


def _ref_tree(seed=3):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(64, 128).astype(np.float32) * 0.1,
            "proj": {"k": rng.randn(40, 130).astype(np.float32) * 0.1},
            "s": rng.randn(8).astype(np.float32)}


@pytest.mark.parametrize("wd,accum", [(0.0, 1), (0.1, 2)])
def test_dpa_optimizer_equals_the_optax_chain(wd, accum):
    """Two updates (lr(0) = 0 first, then the warmup's next rate), clipping
    active on the second: the params equal the reference chain's."""
    kw = dict(optim="adamw8bit", learning_rate=1e-2, weight_decay=wd,
              grad_accum_steps=accum, num_train_steps=10, warmup_ratio=0.2,
              max_grad_norm=5.0)
    params = _ref_tree()
    tx = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw), params)
    jp = jax.tree.map(jnp.asarray, params)
    jst = tx.init(jp)
    tp = tree.to_torch({k: v for k, v in jax.tree.map(np.copy, params)
                        .items()}, device="cpu")
    opt = trainer.DPAOptimizer(trainer.TrainConfig(**kw), tp)
    assert isinstance(opt.adamw, optim8bit.AdamW8bit)
    rng = np.random.RandomState(1)
    leaves = [x for _, x in tree.flatten(tp)]
    for i in range(2 * accum):
        scale = 30.0 if i >= accum else 1.0  # the second update clips
        g = jax.tree.map(lambda p: (rng.randn(*p.shape) * scale).astype(
            np.float32), params)
        upd, jst = tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for _, x in tree.flatten(g)])
    assert opt.updates == 2
    for (path, got), (_, want) in zip(tree.flatten(tp),
                                      tree.flatten(jax.tree.map(np.asarray,
                                                                jp))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-8,
                                   err_msg=str(path))
    moved = float(np.abs(tp["w"].numpy() - params["w"]).max())
    assert moved > 1e-3


def test_dpa_step_with_8bit_moments_matches_reference():
    """Four micro-steps at grad_accum 2 of the LLAVA_TINY train step under
    optim="adamw8bit" against the reference's jitted step."""
    from test_torch_trainer import _batches, _jax_state, _np_policy, \
        _torch_state

    np_lp = _np_policy()
    lr = 1e-3
    kw = dict(learning_rate=lr, grad_accum_steps=2, num_train_steps=10,
              warmup_ratio=0.1, loss_chunk=8, optim="adamw8bit")
    jt, jf, jst, jstep, _ = _jax_state(np_lp, **kw)
    jstep = jax.jit(jstep)
    tt, tf, tst, tstep, _ = _torch_state(np_lp, **kw)
    for batch in _batches(4):
        jt, jst, jm = jstep(jt, jf, None, jst,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        tt, tst, tm = tstep(tt, tf, None, tst,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        for g, w in zip(tm, jm):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    assert tst.updates == 2
    want = dict(tree.flatten(jax.tree.map(np.asarray, jt)))
    init = dict(tree.flatten(np_lp))
    moved = 0
    for path, g in tree.flatten(tt):
        if g is None:
            continue
        np.testing.assert_allclose(g.detach().numpy(), want[path], rtol=0,
                                   atol=lr / 10, err_msg=str(path))
        moved += int(np.abs(want[path] - np.asarray(init[path])).max()
                     > lr / 2)
    assert moved > 0
