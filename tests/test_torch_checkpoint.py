"""The port's checkpoints (halva_tpu_torch/train/checkpoint.py and
train/vila.py) against the reference's halva_tpu/train/checkpoint.py and
train/vila.py, and the bf16 adapter without ml_dtypes.

- save_params / load_params: a tree with bf16, fp32, int8, uint8 (NF4 code
  indices) and int32 leaves round-trips bit for bit, and equals the
  reference's orbax round trip of the same numpy tree. The files differ by
  design (no orbax on the card); only the trees are held equal.
- CheckpointManager keeps the newest `max_to_keep` steps, finds the latest
  complete one and ignores a save that never finished; it restores AdamW's
  state and, under optim="adamw8bit", the quantized moments bit for bit,
  and refuses a checkpoint of the other optim kind.
- save_components gives the reference's directory names and an equal
  config.json; the port's builder loads a component checkpoint (and a
  save_params dir) into the tree the reference's builder gives for its own
  component checkpoint of the same tree, bit for bit.
- A bf16 adapter goes lora_state_dict -> save_adapter -> load_adapter ->
  load_lora_state_dict bit for bit in a process where `import ml_dtypes`
  fails; its payloads and shapes equal the reference's save_adapter of the
  same adapter, and the reference's own bf16 adapter.npz loads into the
  same tensors.
Tolerance: none, every comparison is exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY
from halva_tpu.train import checkpoint as jckpt
from halva_tpu.train import lora as jlora
from halva_tpu.train import vila as jvila
from halva_tpu_torch import tree
from halva_tpu_torch.train import checkpoint as ckpt
from halva_tpu_torch.train import lora
from halva_tpu_torch.train import vila
from halva_tpu_torch.utils import treecache

from test_torch_tree import jax_tree, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_numpy_tree():
    import ml_dtypes

    rng = np.random.RandomState(0)
    return {
        "w": {"kernel": rng.randn(3, 4, 5).astype(ml_dtypes.bfloat16),
              "scale": rng.randn(5).astype(np.float32)},
        "q": {"kernel_q": rng.randint(-127, 128, (4, 6)).astype(np.int8),
              "kernel_q4": rng.randint(0, 16, (2, 8)).astype(np.uint8)},
        "meta": {"stamp": np.arange(3, dtype=np.int32)},
        "layers": [{"b": rng.randn(2).astype(np.float32)},
                   {"b": rng.randn(2).astype(np.float32)}],
    }


def _assert_same(got, want):
    """Bit for bit, dtype for dtype (torch against numpy)."""
    g, w = dict(tree.flatten(got)), dict(tree.flatten(want))
    assert set(g) == set(w)
    for k, t in g.items():
        a = np.asarray(w[k])
        assert isinstance(t, torch.Tensor), k
        assert tree.to_numpy(t).dtype == a.dtype, k
        assert tuple(t.shape) == a.shape, k
        assert tree.to_numpy(t).tobytes() == a.tobytes(), k


def test_save_params_round_trip_equals_the_references(tmp_path):
    np_tree = _mixed_numpy_tree()
    ckpt.save_params(str(tmp_path / "port"), tree.to_torch(np_tree, "cpu"))
    assert os.listdir(tmp_path / "port") == [ckpt.PARAMS_FILE]
    got = ckpt.load_params(str(tmp_path / "port"), device="cpu")
    _assert_same(got, np_tree)
    assert isinstance(got["layers"], list)
    jckpt.save_params(str(tmp_path / "ref"), np_tree)
    want = jckpt.load_params(str(tmp_path / "ref"))
    _assert_same(got, jax.tree.map(np.asarray, want))
    # a template gives its dtypes and must match the tree
    like = tree.map_tree(lambda t: t.float(), got)
    cast = ckpt.load_params(str(tmp_path / "port"), like, device="cpu")
    assert cast["w"]["kernel"].dtype == torch.float32
    assert torch.equal(cast["w"]["kernel"], got["w"]["kernel"].float())
    with pytest.raises(ValueError, match="differs from the template"):
        ckpt.load_params(str(tmp_path / "port"), {"w": like["w"]},
                         device="cpu")
    like["w"]["scale"] = torch.zeros(6)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params(str(tmp_path / "port"), like, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.load_params(str(tmp_path / "nowhere"), device="cpu")


def test_tree_file_is_the_quantized_cache_format(tmp_path):
    """save_params writes the tree cache's own format (one writer, one
    reader), without a config record."""
    ckpt.save_params(str(tmp_path / "d"),
                     tree.to_torch(_mixed_numpy_tree(), "cpu"))
    back, meta = treecache.read_tree(str(tmp_path / "d" / ckpt.PARAMS_FILE))
    assert "config" not in meta and meta["schema"] == treecache.SCHEMA
    _assert_same(back, _mixed_numpy_tree())


def _tiny_state(rank=2, optim="adamw"):
    from halva_tpu_torch.train import trainer

    params = tree.to_torch(jax_tree(LLAVA_TINY), "cpu")
    policy = lora.add_lora(params, torch.Generator().manual_seed(0),
                           rank=rank)
    tcfg = trainer.TrainConfig(grad_accum_steps=2, learning_rate=1e-2,
                               optim=optim)
    return trainer.init_train_state(policy, tcfg)


def test_checkpoint_manager_keeps_the_newest_steps(tmp_path):
    trainable, _, _, opt = _tiny_state()
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3):
        assert mgr.save(step, trainable, opt)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    # as orbax's manager: a step at or below the latest is not written again
    assert not mgr.save(3, trainable, opt) and not mgr.save(2, trainable, opt)
    assert mgr.all_steps() == [2, 3]
    # an interrupted save leaves a temporary name, which is never a step
    os.makedirs(tmp_path / "ck" / ".4.999.tmp")
    os.makedirs(tmp_path / "ck" / "5")  # a step dir without its file
    assert mgr.latest_step() == 3
    again = ckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert again.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).restore(
            trainable, opt)


def test_checkpoint_manager_restores_the_whole_optimizer(tmp_path):
    """Adam's moments and count, the accumulators mid-cycle, the schedule
    and the mini-step, keyed by path, into a fresh state in place."""
    trainable, frozen, _, opt = _tiny_state()
    leaves = [(k, x) for k, x in tree.flatten(trainable) if x is not None]
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):  # one update, then one mini-step into the next
        opt.step([torch.randn(x.shape, generator=gen) for _, x in leaves])
    assert opt.updates == 1 and opt.mini_step == 1
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, trainable, opt)

    fresh, _, _, opt2 = _tiny_state()
    got, opt_back, step = mgr.restore(fresh, opt2)
    assert step == 3 and got is fresh and opt_back is opt2
    assert opt2.updates == 1 and opt2.mini_step == 1
    assert [g["lr"] for g in opt2.adamw.param_groups] == [
        g["lr"] for g in opt.adamw.param_groups]
    new = [x for _, x in tree.flatten(fresh) if x is not None]
    for (_, a), b, acc_a, acc_b in zip(leaves, new, opt.acc, opt2.acc):
        assert torch.equal(a, b) and torch.equal(acc_a, acc_b)
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.adamw.state[a][name],
                               opt2.adamw.state[b][name]), name
    # both go on identically from here
    g = [torch.randn(x.shape, generator=gen) for _, x in leaves]
    opt.step(g)
    opt2.step(g)
    for (_, a), b in zip(leaves, new):
        assert torch.equal(a, b)


def test_checkpoint_manager_restores_the_8bit_moments(tmp_path):
    """optim="adamw8bit": the int8 / uint8 codes, their scales, the fp32
    moments of the small leaves and the count round-trip bit for bit; the
    restored optimizer goes on as the saved one; a checkpoint of one optim
    kind is refused under the other, naming both."""
    # rank 24 on LLAVA_TINY: leaves of 3,072 elements keep fp32 moments,
    # those of 6,144 are quantized
    trainable, _, _, opt = _tiny_state(rank=24, optim="adamw8bit")
    leaves = [x for _, x in tree.flatten(trainable) if x is not None]
    gen = torch.Generator().manual_seed(5)
    for _ in range(5):  # two updates, then one mini-step into the third
        opt.step([torch.randn(x.shape, generator=gen) for x in leaves])
    assert opt.updates == 2 and opt.mini_step == 1
    kinds = {tuple(sorted(st)) for st in opt.adamw.state.values()}
    assert kinds == {("m", "step", "v"),
                     ("m_q", "m_s", "step", "v_q", "v_s")}
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(5, trainable, opt)

    fresh, _, _, opt2 = _tiny_state(rank=24, optim="adamw8bit")
    mgr.restore(fresh, opt2)
    new = [x for _, x in tree.flatten(fresh) if x is not None]
    assert opt2.updates == 2 and opt2.mini_step == 1
    for a, b in zip(leaves, new):
        assert torch.equal(a, b)
        sa, sb = opt.adamw.state[a], opt2.adamw.state[b]
        assert set(sa) == set(sb)
        for name in sa:
            assert sa[name].dtype == sb[name].dtype, name
            assert torch.equal(sa[name], sb[name]), name
        assert sb["step"].device.type == "cpu"
    g = [torch.randn(x.shape, generator=gen) for x in leaves]
    opt.step(g)
    opt2.step(g)
    assert opt.updates == opt2.updates == 3
    for a, b in zip(leaves, new):
        assert torch.equal(a, b)

    _, _, _, plain = _tiny_state(rank=24)
    with pytest.raises(ValueError, match="'adamw8bit'.*'adamw'"):
        mgr.restore(_tiny_state(rank=24)[0], plain)
    mgr2 = ckpt.CheckpointManager(str(tmp_path / "ck2"))
    mgr2.save(1, _tiny_state(rank=24)[0], plain)
    with pytest.raises(ValueError, match="'adamw'.*'adamw8bit'"):
        mgr2.restore(fresh, opt2)


def _bf16_lora_numpy_tree():
    params = jax.tree.map(jnp.asarray, jax_tree(LLAVA_TINY, jnp.bfloat16))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=4, alpha=8)
    rng = np.random.RandomState(2)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape) * 0.05, jnp.bfloat16)
    return jax.tree.map(np.asarray, lp)


def test_components_layout_and_config_equal_the_references(tmp_path):
    np_lp = _bf16_lora_numpy_tree()
    cfg = LLAVA_TINY
    jvila.save_components(str(tmp_path / "ref"), jax.tree.map(
        jnp.asarray, np_lp), cfg)
    vila.save_components(str(tmp_path / "port"),
                         tree.to_torch(np_lp, "cpu"), port_cfg(cfg))
    for d in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "config.json", "llm", "mm_projector", "vision_tower"]
    assert (tmp_path / "port" / "config.json").read_text() == (
        tmp_path / "ref" / "config.json").read_text()
    assert vila.is_component_checkpoint(str(tmp_path / "port"))
    assert vila.load_component_config(str(tmp_path / "port")) == port_cfg(
        cfg)
    back = vila.load_components(str(tmp_path / "port"), device="cpu")
    _assert_same(back, np_lp)


def test_builder_loads_components_as_the_reference_does(tmp_path):
    """The reference's loader on its component checkpoint and the port's on
    its own, of the same bf16 LoRA tree: the merged tree, bit for bit; a
    save_params dir of the same tree with the config.json beside it loads
    the same."""
    from halva_tpu.models import builder as jbuilder
    from halva_tpu_torch.models import builder

    np_lp = _bf16_lora_numpy_tree()
    jvila.save_components(str(tmp_path / "ref"), jax.tree.map(
        jnp.asarray, np_lp), LLAVA_TINY)
    vila.save_components(str(tmp_path / "port"),
                         tree.to_torch(np_lp, "cpu"), port_cfg(LLAVA_TINY))
    want, wcfg = jbuilder.load_pretrained_model(str(tmp_path / "ref"))
    got, gcfg = builder.load_pretrained_model(str(tmp_path / "port"),
                                              device="cpu")
    assert gcfg == port_cfg(wcfg)
    want = jax.tree.map(np.asarray, want)
    _assert_same(got, want)
    assert "lora_a" not in got["llm"]["layers"]["attn"]["wq"]

    whole = str(tmp_path / "whole")
    ckpt.save_params(whole, tree.to_torch(np_lp, "cpu"))
    with open(os.path.join(whole, "config.json"), "w") as f:
        json.dump({"halva_tpu_config": json.load(open(
            tmp_path / "port" / "config.json"))["halva_tpu_config"]}, f)
    got2, cfg2 = builder.load_pretrained_model(whole, device="cpu")
    assert cfg2 == gcfg
    _assert_same(got2, want)
    # without a config.json: the llava-v1.5 preset of the tree's width
    os.remove(os.path.join(whole, "config.json"))
    assert builder.params_dir_config(whole, got2).llm.hidden_size == 4096


CHILD = r"""
import json, sys
sys.modules["ml_dtypes"] = None  # any `import ml_dtypes` now fails
sys.modules["jax"] = None
sys.path.insert(0, %(repo)r)
import numpy as np, torch
from halva_tpu_torch.train import checkpoint, lora
from halva_tpu_torch.utils import treecache

tree, _ = treecache.read_tree(%(tree)r)
sd = lora.lora_state_dict(tree)
checkpoint.save_adapter(%(port)r, sd)
back = checkpoint.load_adapter(%(port)r)
loaded = lora.load_lora_state_dict(lora.strip_lora(tree), back)
again = lora.lora_state_dict(loaded)
same = sorted(again) == sorted(sd) and all(
    again[k].tobytes() == sd[k].tobytes() and again[k].shape == sd[k].shape
    for k in sd)
wq = loaded["llm"]["layers"]["attn"]["wq"]
ref = lora.load_lora_state_dict(lora.strip_lora(tree),
                                checkpoint.load_adapter(%(ref)r))
ref_same = all(
    torch.equal(ref["llm"]["layers"][g][n][k], tree["llm"]["layers"][g][n][k])
    for g, names in (("attn", "wq wk wv wo"), ("mlp", "gate up down"))
    for n in names.split() for k in ("lora_a", "lora_b", "lora_scale"))
print(json.dumps({"same": same, "ref_same": ref_same,
                  "dtype": str(wq["lora_a"].dtype),
                  "kinds": sorted({v.dtype.kind for v in sd.values()}),
                  "ml_dtypes": "ml_dtypes" in sys.modules
                  and sys.modules["ml_dtypes"] is not None}))
"""


def test_bf16_adapter_without_ml_dtypes(tmp_path):
    np_lp = _bf16_lora_numpy_tree()
    paths = {"repo": REPO, "tree": str(tmp_path / "tree.npz"),
             "port": str(tmp_path / "port.npz"),
             "ref": str(tmp_path / "ref.npz")}
    treecache.write_tree(paths["tree"], tree.to_torch(np_lp, "cpu"))
    want = jlora.lora_state_dict(jax.tree.map(jnp.asarray, np_lp))
    jckpt.save_adapter(paths["ref"], want)
    p = subprocess.run([sys.executable, "-c", CHILD % paths],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"same": True, "ref_same": True, "dtype": "torch.bfloat16",
                   "kinds": ["V"], "ml_dtypes": False}
    with np.load(paths["port"]) as port, np.load(paths["ref"]) as ref:
        assert sorted(port.files) == sorted(ref.files) == sorted(want)
        for k in ref.files:
            assert port[k].dtype.itemsize == ref[k].dtype.itemsize == 2, k
            assert port[k].shape == ref[k].shape, k
            assert port[k].tobytes() == ref[k].tobytes(), k
