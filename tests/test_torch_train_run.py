"""The port's train entry point (halva_tpu_torch/train/run.py) against the
reference's halva_tpu/train/run.py, on the CPU.

- The loop: both packages' `train` on llava-tiny in fp32, grad_accum_steps
  2, 4 micro-steps, the same HallDataset files (test_train_e2e._make_data,
  SPTok) and the same initial policy: the reference's build_models output
  with a perturbed lora_b (at B = 0 the KL and the lora_a grads are exactly
  0), bridged into the port through a monkeypatched build_models. The
  reference runs on one device (its make_mesh patched to
  single_device_mesh), so both take the same per-device batch and index
  stream. Metrics at every step within rtol 1e-4 (one micro-step is held at
  1e-5 in test_torch_trainer.py; this loop compounds two updates); the
  final adapters within lr / 10 per element (an update moves a param by up
  to ~lr; Adam's 1/sqrt(v) magnifies tiny grad differences).
- Resume: 6 micro-steps at grad_accum 2 stopped by max_steps=3 (the
  accumulators mid-cycle) and resumed equal an uninterrupted run bit for
  bit (metrics and adapter); a call after the end runs no step.
- The frozen reference's projector is a real copy under tune_mm_projector
  and mm_projector_lr: it does not move with the policy's.
- The packed loop (--pack true, with AdamW and with --optim adamw8bit)
  against the reference's packed loop: the same metrics within rtol 1e-4
  and adapters within lr / 10; stopped at 2 and resumed to 4 under
  --optim adamw8bit it equals the uninterrupted run bit for bit, and its
  checkpoint is refused under the other optim.
- main(argv): the reference's flags plus --device; one step on the CPU
  with a tests/tokutil.py tokenizer; a mesh that does not fit the run's
  processes raises before anything loads, and a batch whose rows do not
  divide the data axis is refused (tests/test_torch_mesh_train.py runs the
  CLI on a {2, 2} mesh of gloo ranks)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.mm_utils import ImageProcessor as JImageProcessor
from halva_tpu.parallel import mesh as jmesh
from halva_tpu.train import lora as jlora
from halva_tpu.train import run as jrun
from halva_tpu.train.data import HallDataset as JHallDataset
from halva_tpu_torch import tree
from halva_tpu_torch.mm_utils import ImageProcessor
from halva_tpu_torch.train import run
from halva_tpu_torch.train.data import HallDataset

from test_data_pipeline import SPTok
from test_torch_tree import port_cfg
from test_train_e2e import _make_data

torch.set_num_threads(2)

LR = 1e-3


def _datasets(tmp_path):
    dp, rp, img = _make_data(tmp_path, tags=("closed", "open"))
    tok = SPTok()

    def port():
        return HallDataset(dp, rp, tok, ImageProcessor(size=28, crop_size=28),
                           image_folder=img, max_length=128)

    def ref():
        return JHallDataset(dp, rp, tok,
                            JImageProcessor(size=28, crop_size=28),
                            image_folder=img, max_length=128)

    return (dp, rp, img), tok, port, ref


def _rcfg(cls, out, files, **kw):
    dp, rp, img = files
    base = dict(model="llava-tiny", output_dir=str(out), data_path=dp,
                ref_data_path=rp, image_folder=img, per_device_batch=2,
                grad_accum_steps=2, learning_rate=LR, lora_r=4,
                lora_alpha=8.0, max_length=128, dtype="float32")
    base.update(kw)
    return cls(**base)


def _ref_policy():
    """The reference's build_models policy (fp32, r=4) with a perturbed
    lora_b, as numpy."""
    base = jrun.llava.init_params(jax.random.PRNGKey(0), LLAVA_TINY,
                                  jnp.float32)
    lp = jlora.add_lora(base, jax.random.PRNGKey(42), rank=4, alpha=8.0)
    rng = np.random.RandomState(5)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape).astype(np.float32) * 0.05)
    return jax.tree.map(np.array, lp)


def _metrics(path):
    return {m["step"]: m for m in map(json.loads, open(path))}


def test_train_loop_equals_the_reference(tmp_path, monkeypatch):
    files, tok, port_ds, ref_ds = _datasets(tmp_path)
    np_policy = _ref_policy()
    one = jmesh.single_device_mesh()  # before make_mesh is patched
    monkeypatch.setattr(jrun.mesh_lib, "make_mesh", lambda **kw: one)
    monkeypatch.setattr(jrun, "build_models", lambda rcfg, cfg, tok: (
        jax.tree.map(jnp.asarray, np_policy), None, cfg))
    monkeypatch.setattr(run, "build_models", lambda rcfg, cfg, tok: (
        tree.to_torch(jax.tree.map(np.copy, np_policy), device="cpu"), None,
        cfg))

    jrun.train(_rcfg(jrun.RunConfig, tmp_path / "ref", files, max_steps=4),
               tok, dataset=ref_ds())
    final = run.train(_rcfg(run.RunConfig, tmp_path / "port", files,
                            max_steps=4, device="cpu"),
                      tok, dataset=port_ds())
    want = _metrics(tmp_path / "ref" / "metrics.jsonl")
    got = _metrics(tmp_path / "port" / "metrics.jsonl")
    assert set(got) == set(want) == {1, 2, 3, 4}
    assert set(got[1]) == set(want[1])  # the same JSONL keys
    for step in want:
        for key in ("loss", "alignment", "kl", "grad_norm"):
            np.testing.assert_allclose(got[step][key], want[step][key],
                                       rtol=1e-4, err_msg=f"{step} {key}")
    assert want[4]["kl"] > 0
    a = np.load(tmp_path / "port" / "adapter.npz")
    b = np.load(tmp_path / "ref" / "adapter.npz")
    assert sorted(a.files) == sorted(b.files)
    moved = 0.0
    for k in b.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=LR / 10,
                                   err_msg=k)
        moved = max(moved, float(np.abs(a[k] - np.asarray(
            jlora.lora_state_dict(np_policy)[k])).max()))
    assert moved > LR / 2  # the adapters did train
    assert isinstance(final["llm"]["layers"]["attn"]["wq"]["lora_a"],
                      torch.Tensor)


@pytest.mark.parametrize("optim", ["adamw", "adamw8bit"])
def test_packed_loop_equals_the_reference(tmp_path, monkeypatch, optim):
    """--pack true (and --optim): both packages' loops on the same files
    and policy pack the same batches (the batcher's default shapes: 2 pn
    rows and 1 ref row of r64(max_length + T - 1) tokens, <= 2 samples a
    step) and log the same metrics within rtol 1e-4; the adapters agree
    within lr / 10."""
    files, tok, port_ds, ref_ds = _datasets(tmp_path)
    np_policy = _ref_policy()
    one = jmesh.single_device_mesh()
    monkeypatch.setattr(jrun.mesh_lib, "make_mesh", lambda **kw: one)
    monkeypatch.setattr(jrun, "build_models", lambda rcfg, cfg, tok: (
        jax.tree.map(jnp.asarray, np_policy), None, cfg))
    monkeypatch.setattr(run, "build_models", lambda rcfg, cfg, tok: (
        tree.to_torch(jax.tree.map(np.copy, np_policy), device="cpu"), None,
        cfg))
    kw = dict(max_steps=4, pack=True, optim=optim)
    jrun.train(_rcfg(jrun.RunConfig, tmp_path / "ref", files, **kw), tok,
               dataset=ref_ds())
    run.train(_rcfg(run.RunConfig, tmp_path / "port", files, device="cpu",
                    **kw), tok, dataset=port_ds())
    want = _metrics(tmp_path / "ref" / "metrics.jsonl")
    got = _metrics(tmp_path / "port" / "metrics.jsonl")
    assert set(got) == set(want) == {1, 2, 3, 4}
    for step in want:
        for key in ("loss", "alignment", "kl", "grad_norm"):
            np.testing.assert_allclose(got[step][key], want[step][key],
                                       rtol=1e-4, err_msg=f"{step} {key}")
    assert want[4]["kl"] > 0
    with np.load(tmp_path / "port" / "adapter.npz") as a, np.load(
            tmp_path / "ref" / "adapter.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=LR / 10,
                                       err_msg=k)


def test_packed_8bit_resume_is_bit_exact(tmp_path, monkeypatch):
    """The CLI's flags --pack true --optim adamw8bit on the CPU: 4
    micro-steps at grad_accum 2 stopped at 2 (the quantized moments and the
    packed stream saved and skipped) and resumed to 4 equal an
    uninterrupted run bit for bit, metrics and adapter; a checkpoint of
    these moments is refused under --optim adamw."""
    files, tok, port_ds, _ = _datasets(tmp_path)
    dp, rp, img = files
    saved = []
    real = run.ckpt_lib.CheckpointManager.save

    def spy(self, step, trainable, opt_state):
        saved.append(sorted({n for st in opt_state.adamw.state.values()
                             for n in st}))
        return real(self, step, trainable, opt_state)

    monkeypatch.setattr(run.ckpt_lib.CheckpointManager, "save", spy)

    def go(out, max_steps, optim="adamw8bit"):
        argv = ["--model", "llava-tiny", "--data-path", dp,
                "--ref-data-path", rp, "--image-folder", img,
                "--per-device-batch", "2", "--grad-accum-steps", "2",
                "--learning-rate", str(LR), "--lora-r", "4",
                "--lora-alpha", "8", "--max-length", "128",
                "--dtype", "float32", "--pack", "true", "--optim", optim,
                "--max-steps", str(max_steps), "--save-steps", "2",
                "--output-dir", str(tmp_path / out), "--device", "cpu"]
        rcfg = run.parse_args(argv)
        assert rcfg.pack and rcfg.optim == optim
        return run.train(rcfg, tok, dataset=port_ds())

    go("full", 4)
    go("split", 2)
    go("split", 4)
    assert saved[0] == ["m", "step", "v"]  # LLAVA_TINY's leaves are small
    full = _metrics(tmp_path / "full" / "metrics.jsonl")
    split = _metrics(tmp_path / "split" / "metrics.jsonl")
    assert set(full) == set(split) == {1, 2, 3, 4}
    for step in (3, 4):
        assert split[step] | {"time": 0, "step_time": 0} == (
            full[step] | {"time": 0, "step_time": 0}), step
    with np.load(tmp_path / "full" / "adapter.npz") as a, np.load(
            tmp_path / "split" / "adapter.npz") as b:
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
        # update 2 (step 4) moved lora_b off its zero init
        assert any(np.abs(a[k]).max() > 0 for k in a.files
                   if "lora_B" in k or "lora_b" in k)
    with pytest.raises(ValueError, match="adamw8bit.*adamw"):
        go("split", 6, optim="adamw")


def test_resume_mid_cycle_is_bit_exact(tmp_path):
    files, tok, port_ds, _ = _datasets(tmp_path)

    def go(out, max_steps):
        return run.train(_rcfg(run.RunConfig, tmp_path / out, files,
                               max_steps=max_steps, device="cpu"),
                         tok, dataset=port_ds())

    go("full", 6)
    go("split", 3)
    ckpts = tmp_path / "split" / "checkpoints"
    assert os.listdir(ckpts) == ["3"]
    go("split", 6)
    full = _metrics(tmp_path / "full" / "metrics.jsonl")
    split = _metrics(tmp_path / "split" / "metrics.jsonl")
    assert set(full) == set(split) == {1, 2, 3, 4, 5, 6}
    for step in (4, 5, 6):
        assert split[step] | {"time": 0, "step_time": 0} == (
            full[step] | {"time": 0, "step_time": 0}), step
    assert full[6]["kl"] > 0
    with np.load(tmp_path / "full" / "adapter.npz") as a, np.load(
            tmp_path / "split" / "adapter.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    # a call after the end restores step 6 and runs nothing
    lines = open(tmp_path / "split" / "metrics.jsonl").read()
    go("split", 6)
    assert open(tmp_path / "split" / "metrics.jsonl").read() == lines
    assert sorted(os.listdir(ckpts), key=int) == ["3", "6"]


@pytest.mark.parametrize("knob", [{"tune_mm_projector": True},
                                  {"mm_projector_lr": 1e-2}])
def test_reference_projector_is_a_real_copy(tmp_path, monkeypatch, knob):
    """The train step updates the trainable leaves in place, so the frozen
    reference's projector must be a copy taken before the first step: after
    two updates it still holds the initial values, while the policy's
    moved."""
    from halva_tpu_torch.train import trainer

    files, tok, port_ds, _ = _datasets(tmp_path)
    seen = {}
    real = trainer.dpa_step_fns

    def spy(cfg, tcfg, opt):
        step, ev = real(cfg, tcfg, opt)

        def wrapped(trainable, frozen, ref_params, opt_state, batch):
            seen.setdefault("ref", ref_params)
            seen.setdefault("initial", tree.map_tree(
                lambda t: t.detach().clone(), trainable["projector"]))
            return step(trainable, frozen, ref_params, opt_state, batch)

        return wrapped, ev

    monkeypatch.setattr(trainer, "dpa_step_fns", spy)
    final = run.train(_rcfg(run.RunConfig, tmp_path / "o", files,
                            max_steps=6, device="cpu", **knob),
                      tok, dataset=port_ds())
    ref = dict(tree.flatten(seen["ref"]["projector"]))
    initial = dict(tree.flatten(seen["initial"]))
    policy = dict(tree.flatten(final["projector"]))
    assert set(ref) == set(initial) == set(policy)
    for k in ref:
        assert torch.equal(ref[k], initial[k]), k
        assert ref[k].data_ptr() != policy[k].data_ptr(), k
    assert any(not torch.equal(policy[k], initial[k]) for k in ref)


def test_flags_are_the_references_plus_device():
    jf = [(f.name, f.default) for f in dataclasses.fields(jrun.RunConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(run.RunConfig)]
    assert tf[:-1] == jf and tf[-1] == ("device", "cuda")
    argv = ["--model", "llava-tiny", "--epochs", "1.5", "--max-steps", "3",
            "--mm-projector-lr", "2e-5", "--tune-mm-projector", "true",
            "--lora-alpha", "16", "--mesh-data", "1"]
    got = run.parse_args(argv + ["--device", "cpu"])
    assert got.device == "cpu"
    assert got.epochs == 1.5 and got.max_steps == 3
    assert got.tune_mm_projector is True and got.lora_alpha == 16.0
    assert got.mesh_data == 1 and got.mm_projector_lr == 2e-5
    assert dataclasses.asdict(run.parse_args(argv)) == dict(
        dataclasses.asdict(got), device="cuda")


@pytest.mark.parametrize("argv,world,match", [
    (["--mesh-data", "2"], None, "mesh 2x1 != the 1 processes"),
    (["--mesh-model", "2"], None, "mesh_model=2 does not divide the 1"),
    (["--mesh-model", "3"], "4", "mesh_model=3 does not divide the 4"),
    (["--mesh-data", "3", "--mesh-model", "2"], "4", "mesh 3x2 != the 4"),
])
def test_a_mesh_that_does_not_fit_raises_before_loading(
        tmp_path, monkeypatch, argv, world, match):
    """The mesh flags against the run's processes (WORLD_SIZE as torchrun
    sets it, 1 without it): ValueError before the tokenizer, the data or
    the model loads, and before a process group is joined."""
    monkeypatch.setenv("HALVA_TOKENIZER", str(tmp_path / "no-tokenizer"))
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)

    def never(*a, **k):
        raise AssertionError("loaded a model")

    monkeypatch.setattr(run, "build_models", never)
    with pytest.raises(ValueError, match=match):
        run.main(argv + ["--model", "llava-tiny", "--device", "cpu",
                         "--output-dir", str(tmp_path / "o")])
    rcfg = run.parse_args(argv + ["--model", "llava-tiny"])
    with pytest.raises(ValueError, match=match):
        run.train(rcfg, None, dataset=[])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world,argv,want", [
    ("1", [], None),
    ("1", ["--mesh-data", "1", "--mesh-model", "1"], None),
    ("4", [], (4, 1)),
    ("4", ["--mesh-model", "2"], (2, 2)),
    ("8", ["--mesh-data", "2", "--mesh-model", "4"], (2, 4)),
])
def test_mesh_flags_parse_to_the_runs_mesh(monkeypatch, world, argv, want):
    monkeypatch.setenv("WORLD_SIZE", world)
    assert run.mesh_axes(run.parse_args(argv)) == want


@pytest.mark.parametrize("packed", [False, True])
def test_rows_that_do_not_divide_the_data_axis_raise(packed):
    """A train step on a mesh takes each rank's rows: 3 rows over data 2
    raise ValueError naming the data axis (a packed batch's 1-dim scatter
    plans and n_samples are whole on every rank, and checked for
    nothing)."""
    from halva_tpu_torch.parallel import mesh, partition

    two = mesh.mesh_shape({"data": 2, "model": 2})
    rows = np.zeros((3, 8), np.int32)
    batch = ({"pn_input_ids": rows, "pn_img_row": np.zeros(5, np.int32),
              "n_samples": np.int32(3)} if packed else
             {"input_ids": rows, "images": np.zeros((3, 3, 4, 4))})
    with pytest.raises(ValueError, match="data axis size"):
        partition.check_train_rows(batch, two, packed)
    even = {k: (v[:2] if np.ndim(v) == 2 else v) for k, v in batch.items()}
    if not packed:
        even["images"] = batch["images"][:2]
    partition.check_train_rows(even, two, packed)


def test_main_runs_a_step_on_the_cpu(tmp_path, monkeypatch):
    """The CLI end to end: a tokutil tokenizer from HALVA_TOKENIZER, the
    data files, one micro-step, the adapter and component dirs written,
    and the component checkpoint loads back through the eval builder."""
    from tokutil import build_tiny_tokenizer

    from halva_tpu_torch.models import builder

    build_tiny_tokenizer(str(tmp_path / "tok"))
    dp, rp, img = _make_data(tmp_path, tags=("closed", "open"))
    monkeypatch.setenv("HALVA_TOKENIZER", str(tmp_path / "tok"))
    out = tmp_path / "out"
    run.main(["--model", "llava-tiny", "--data-path", dp,
              "--ref-data-path", rp, "--image-folder", img,
              "--per-device-batch", "1", "--grad-accum-steps", "1",
              "--lora-r", "4", "--max-length", "256", "--max-steps", "1",
              "--dtype", "float32", "--save-component-dirs", "true",
              "--output-dir", str(out), "--device", "cpu"])
    m = _metrics(out / "metrics.jsonl")
    assert list(m) == [1] and np.isfinite(m[1]["loss"])
    assert (out / "adapter.npz").exists()
    assert os.listdir(out / "checkpoints") == ["1"]
    params, cfg = builder.load_pretrained_model(
        str(out / "components"), dtype=torch.float32, device="cpu")
    assert cfg == port_cfg(LLAVA_TINY)
    assert "lora_a" not in params["llm"]["layers"]["attn"]["wq"]


def test_vila_main_runs_its_steps(tmp_path, monkeypatch):
    """The VILA CLI with its recipe's defaults (mlp_downsample, the
    projector trained beside LoRA, component dirs) runs 2 steps on the CPU
    with the preset cut to tiny widths and a tower on a 3 x 3 grid, which
    the projector pads to 2 x 2 before folding. The projector's leaves are
    in the checkpointed trainable set, and the component dir loads back
    through the eval builder with its config and decodes."""
    from halva_tpu_torch.config import PRESETS
    from halva_tpu_torch.models import builder
    from halva_tpu_torch.ops import generate
    from halva_tpu_torch.train import vila

    vila_tiny = dataclasses.replace(
        port_cfg(LLAVA_TINY), mm_projector_type="mlp_downsample",
        vision=dataclasses.replace(port_cfg(LLAVA_TINY.vision),
                                   image_size=42))
    assert vila_tiny.num_image_tokens == 4
    monkeypatch.setitem(PRESETS, "vila-13b-384", vila_tiny)
    monkeypatch.setenv("HALVA_TOKENIZER", str(tmp_path / "tok"))
    from tokutil import build_tiny_tokenizer

    build_tiny_tokenizer(str(tmp_path / "tok"))
    dp, rp, img = _make_data(tmp_path, tags=("closed", "open"))
    out = tmp_path / "v"
    vila.main(["--data-path", dp, "--ref-data-path", rp,
               "--image-folder", img, "--per-device-batch", "1",
               "--grad-accum-steps", "1", "--max-steps", "2",
               "--lora-r", "2", "--max-length", "256",
               "--model-max-length", "256", "--dtype", "float32",
               "--output-dir", str(out), "--device", "cpu"])
    m = _metrics(out / "metrics.jsonl")
    assert list(m) == [1, 2]
    assert all(np.isfinite(m[k]["loss"]) for k in m)
    from halva_tpu_torch.utils import treecache

    state, _ = treecache.read_tree(str(out / "checkpoints" / "2" /
                                       "state.npz"))
    assert any(k.startswith("projector") for k in state["params"])
    params, cfg = builder.load_pretrained_model(
        str(out / "components"), dtype=torch.float32, device="cpu")
    assert cfg == vila_tiny
    assert "lora_a" not in params["llm"]["layers"]["attn"]["wq"]
    ids = torch.full((2, 8), 5, dtype=torch.int32)
    ids[:, 1] = -200
    imgs = torch.randn(2, 3, 42, 42, generator=torch.Generator()
                       .manual_seed(0))
    with torch.inference_mode():
        tok, num = generate.generate_greedy(
            params, cfg, ids, imgs, torch.tensor([8, 6], dtype=torch.int32),
            max_new_tokens=4, eos_id=-1)
    assert tok.shape == (2, 4) and num.tolist() == [4, 4]
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.llm.vocab_size