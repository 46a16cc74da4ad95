"""DPA training on the port's device mesh (trainer.init_train_state(mesh=),
dpa_step_fns / packed_dpa_step_fns(mesh=), checkpoints and the train CLIs
with --mesh-data / --mesh-model) on 4 gloo ranks on the CPU, held against
the port's single-device step and the reference's mesh step
(halva_tpu/train/trainer.py on jax.devices()[:4], as
tests/test_trainer.py's mesh tests run it) on LLAVA_TINY in fp32, LoRA r=4
and a perturbed lora_b (r=32 for the 8-bit moments: leaves of 4,096
elements and more get quantized blocks), remat on.

One spawn of 4 ranks runs every case of torch_mesh_workers.TRAIN_CASES
({data 4, model 1} and {data 2, model 2}: unpacked with loss_chunk off and
8, packed, --optim adamw8bit, grad_accum_steps=2), the checkpoint case and
both CLIs, while this process computes the references; each comparison is
then one parametrized test. Tolerances (fp32 reassociation: the ranks sum
their rows' partial sums, one device sums them in one reduction):
- loss, alignment and KL within rtol 2e-5, the reference's own tolerance
  for its mesh step (tests/test_trainer.py);
- the grad norm within rtol 1e-5; the LoRA grads within 1e-5 of each
  leaf's largest |grad|;
- the updated LoRA leaves within rtol 1e-5 (and 1e-6 absolute, lr / 1000,
  for elements near 0); against the reference within lr / 10, the bound
  tests/test_torch_trainer.py holds the port's one-device update to: the
  port's grads differ from the reference's by ~2e-6 of a leaf's largest,
  and Adam's first direction g / (|g| + eps) turns that into a visible
  difference where |g| lies within a few eps of 0 (measured up to
  5e-5 = lr / 20 on one element of 4,096).
The unpacked batch carries phrase 3 in its first row only, so a rank's own
present-phrase set is not the batch's; the packed batch has a sample whose
positive and negative documents lie on different data ranks. A
model-axis backward that summed would double every TP grad.

Checkpoints: a save on {2, 2} mid-cycle resumes there bit for bit, loads on
one device to the mesh's whole leaves, moments and accumulators, and a
one-device checkpoint loads on the mesh. The train CLI (torchrun's
environment on each rank, per-device batch 1 over data 2) logs the
metrics of the one-device run at per-device batch 2, and the VILA CLI
passes its mesh flags through to the same loop."""

import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halva_tpu.config import LLAVA_TINY as CFG
from halva_tpu.parallel import mesh as jmesh
from halva_tpu.parallel import partition as jpart
from halva_tpu.train import lora as jlora
from halva_tpu.train import trainer as jtrainer
from halva_tpu_torch import tree
from halva_tpu_torch.config import PRESETS, config_to_dict
from halva_tpu_torch.train import checkpoint, run, trainer, vila
from halva_tpu_torch.train.pack import PackedDPABatcher

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_workers as W  # noqa: E402
from test_packed_dpa import IMG, T, _make_items  # noqa: E402
from test_torch_tree import jax_tree, port_cfg  # noqa: E402
from test_train_e2e import _make_data  # noqa: E402
from test_trainer import _fake_batch  # noqa: E402

torch.set_num_threads(2)

CASES = {c[0]: c for c in W.TRAIN_CASES}
# the cases held against the reference's mesh step as well
REF_CASES = ("d4", "d4_chunk", "tp", "tp_chunk", "packed_d4", "packed_tp",
             "adamw8bit_tp")
LOSS_RTOL, NORM_RTOL, LEAF_RTOL, LEAF_ATOL = 2e-5, 1e-5, 1e-5, 1e-6
REF_LEAF_ATOL = W.TRAIN_BASE["learning_rate"] / 10


def _np_policy(rank):
    params = jax.tree.map(jnp.asarray, jax_tree(CFG))
    lp = jlora.add_lora(params, jax.random.PRNGKey(1), rank=rank,
                        alpha=2 * rank)
    rng = np.random.RandomState(5)
    for _, p in jlora._iter_dense(lp):
        if "lora_b" in p:
            p["lora_b"] = jnp.asarray(
                rng.randn(*p["lora_b"].shape).astype(np.float32) * 0.05)
    return jax.tree.map(np.array, lp)


def _rows_batch(seed):
    """tests/test_trainer.py's batch at B=4, phrase 3 in row 0 only."""
    b = _fake_batch(b=4, seed=seed)
    for side in ("", "neg_"):
        b[("neg_signs" if side else "pos_signs")][0, 4:6] = 3
        b[side + "labels"][0, 4:6] = b[side + "input_ids"][0, 4:6]
    return b


def _packed_batch():
    """4 samples (tests/test_packed_dpa.py's items) in 4 pn and 4 ref rows
    of 44 tokens; 8 image slots."""
    b = PackedDPABatcher(seq_len=44, pn_rows=4, ref_rows=4,
                         max_samples=W.MAX_SAMPLES, num_image_tokens=T,
                         pad_token_id=0, image_shape=(3, IMG, IMG))
    (batch,) = list(b.batches(iter(_make_items(4, seed=11))))
    return batch


def _straddlers(batch, n_data):
    """The samples whose positive and negative documents lie on different
    data ranks of n_data."""
    sid, neg = batch["pn_sample_ids"], batch["pn_neg_flags"]
    per = sid.shape[0] // n_data
    out = []
    for s in range(1, int(batch["n_samples"]) + 1):
        ranks = [set(np.nonzero((sid == s) & (neg == f))[0] // per)
                 for f in (0, 1)]
        if ranks[0] != ranks[1]:
            out.append(s)
    return out


def _ref_case(case, payload):
    """The reference's mesh step on jax.devices()[:4]: the metrics and the
    updated LoRA leaves by path."""
    name, dm, kind, policy, kw = case
    tcfg = jtrainer.TrainConfig(attn_impl="xla", **dict(W.TRAIN_BASE, **kw))
    mesh = jmesh.make_mesh(data=dm[0], model=dm[1],
                           devices=jax.devices()[:4])
    tt, tf, opt, st = jtrainer.init_train_state(
        jax.tree.map(jnp.asarray, payload[policy]), tcfg)

    def shard(t):
        return jax.tree.map(jax.device_put, t,
                            jpart.param_shardings(t, mesh))

    if kind == "packed":
        step, _ = jtrainer.packed_dpa_step_fns(CFG, tcfg, opt, W.MAX_SAMPLES,
                                               mesh=mesh)
        batch = jpart.shard_packed_batch(payload["packed"], mesh)
    else:
        step, _ = jtrainer.dpa_step_fns(CFG, tcfg, opt, mesh=mesh)
        batch = jpart.shard_batch(payload["batches"][0], mesh)
    tt, _, m = jax.jit(step)(shard(tt), shard(tf), None, shard(st), batch)
    return {"metrics": [[float(x) for x in m]],
            "params": {"/".join(map(str, p)): np.asarray(x)
                       for p, x in tree.flatten(jax.tree.map(np.asarray, tt))
                       if x is not None}}


def _cli_argv(files, out, tok_pdb, extra=()):
    dp, rp, img = files
    return ["--model", "llava-tiny", "--data-path", dp, "--ref-data-path",
            rp, "--image-folder", img, "--per-device-batch", str(tok_pdb),
            "--grad-accum-steps", "1", "--lora-r", "4",
            "--learning-rate", "1e-3", "--max-length", "256",
            "--max-steps", "3", "--dtype", "float32", "--output-dir", out,
            "--device", "cpu", *extra]


def _vila_argv(files, out, pdb, extra=()):
    dp, rp, img = files
    return ["--data-path", dp, "--ref-data-path", rp, "--image-folder", img,
            "--per-device-batch", str(pdb), "--grad-accum-steps", "1",
            "--max-steps", "2", "--lora-r", "2", "--max-length", "256",
            "--model-max-length", "256", "--dtype", "float32",
            "--output-dir", out, "--device", "cpu", *extra]


def _metrics(path):
    return {m["step"]: m for m in map(json.loads, open(path))}


def _one_device_ckpt(payload, directory):
    """3 micro-steps at grad_accum 2 on one device, saved at 3: the
    checkpoint the ranks load, and this state's whole tree."""
    tcfg = trainer.TrainConfig(**dict(W.TRAIN_BASE, grad_accum_steps=2,
                                      loss_chunk=8))
    params = tree.to_torch(tree.map_tree(np.copy, payload["r4"]),
                           device="cpu")
    tt, tf, opt, st = trainer.init_train_state(params, tcfg)
    step, _ = trainer.dpa_step_fns(port_cfg(CFG), tcfg, opt)
    for b in (payload["batches"] * 2)[:3]:
        tt, st, _ = step(tt, tf, None, st,
                         {k: torch.from_numpy(v) for k, v in b.items()})
    checkpoint.CheckpointManager(directory).save(3, tt, st)
    return tt, st


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tokutil import build_tiny_tokenizer

    tmp = tmp_path_factory.mktemp("mesh_train")
    build_tiny_tokenizer(str(tmp / "tok"))
    old_tok = os.environ.get("HALVA_TOKENIZER")
    os.environ["HALVA_TOKENIZER"] = str(tmp / "tok")  # the ranks' too
    files = _make_data(tmp, tags=("closed", "open"))
    vila_cfg = dataclasses.replace(
        port_cfg(CFG), mm_projector_type="mlp_downsample",
        vision=dataclasses.replace(port_cfg(CFG.vision), image_size=42))
    payload = {
        "cfg": config_to_dict(port_cfg(CFG)), "r4": _np_policy(4),
        "r32": _np_policy(32),
        "batches": [_rows_batch(0), _rows_batch(1)],
        "packed": _packed_batch(),
        "ckpt_dir": str(tmp / "ckpt_mesh"), "ckpt_one": str(tmp / "ckpt_one"),
        "cli_argv": _cli_argv(files, str(tmp / "cli_mesh"), 1,
                              ("--mesh-data", "2", "--mesh-model", "2")),
        "vila_argv": _vila_argv(files, str(tmp / "vila_mesh"), 1,
                                ("--mesh-data", "2", "--mesh-model", "2")),
        "vila_cfg": config_to_dict(vila_cfg),
    }
    one_tt, one_st = _one_device_ckpt(payload, payload["ckpt_one"])
    world = W.World(W.train_cases, 4, payload)
    single = {name: W.train_case(c, payload) for name, c in CASES.items()}
    refs = {name: _ref_case(CASES[name], payload) for name in REF_CASES}
    real = PRESETS["vila-13b-384"]
    try:
        run.main(_cli_argv(files, str(tmp / "cli_one"), 2))
        PRESETS["vila-13b-384"] = vila_cfg
        vila.main(_vila_argv(files, str(tmp / "vila_one"), 2))
    finally:
        PRESETS["vila-13b-384"] = real
        if old_tok is None:
            os.environ.pop("HALVA_TOKENIZER")
        else:
            os.environ["HALVA_TOKENIZER"] = old_tok
    ranks = world.results()
    return SimpleNamespace(tmp=tmp, payload=payload, single=single,
                           refs=refs, ranks=ranks, one=(one_tt, one_st))


def _close_parts(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:3], w[:3], rtol=LOSS_RTOL, err_msg=what)
        np.testing.assert_allclose(g[3], w[3], rtol=NORM_RTOL, err_msg=what)


def _close_leaves(got, want, what, atol=LEAF_ATOL):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LEAF_RTOL, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_equals_the_one_device_step(runs, name):
    got, want = runs.ranks[0][0][name], runs.single[name]
    np.testing.assert_allclose(got["parts"], want["parts"], rtol=LOSS_RTOL)
    _close_parts(got["metrics"], want["metrics"], name)
    assert got["updates"] == want["updates"] >= 1
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{name} {k}")
    _close_leaves(got["params"], want["params"], name)
    assert want["metrics"][-1][2] > 0  # the KL is live


@pytest.mark.parametrize("name", REF_CASES)
def test_mesh_step_equals_the_reference_mesh_step(runs, name):
    got, want = runs.ranks[0][0][name], runs.refs[name]
    _close_parts(got["metrics"], want["metrics"], name)
    _close_leaves(got["params"], want["params"], name, REF_LEAF_ATOL)


def test_every_rank_holds_the_global_metrics_and_leaves(runs):
    first = runs.ranks[0][0]
    for out, _ in runs.ranks[1:]:
        for name in CASES:
            assert out[name]["metrics"] == first[name]["metrics"], name
            for k, v in first[name]["params"].items():
                np.testing.assert_array_equal(out[name]["params"][k], v)


@pytest.mark.parametrize("n_data", [2, 4])
def test_the_packed_batch_straddles_the_data_ranks(runs, n_data):
    """The packed cases hold a sample whose pos and neg documents lie on
    different data ranks (so the phrase sums must meet before the
    nonlinearity), at both mesh shapes' data axes."""
    assert _straddlers(runs.payload["packed"], n_data)


def test_a_local_present_set_would_differ(runs):
    """Row 0 alone carries phrase 3: on {data 4} the other ranks' own sets
    lack it, so a local set would change the alignment."""
    signs = runs.payload["batches"][0]["pos_signs"]
    assert (signs[0] == 3).any() and not (signs[1:] == 3).any()


def test_mesh_checkpoint_resumes_bit_exact(runs):
    ck = runs.ranks[0][0]["ckpt"]
    assert ck["at3"]["mini_step"] == 1 and ck["at3"]["updates"] == 1
    for part in ("at3", "restored3"):
        assert any(np.abs(a).max() > 0 for a in ck[part]["acc"])
    for k, v in ck["at3"]["params"].items():
        np.testing.assert_array_equal(ck["restored3"]["params"][k], v)
    for a, b in zip(ck["at3"]["acc"], ck["restored3"]["acc"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ck["at3"]["moments"], ck["restored3"]["moments"]):
        assert sorted(a) == sorted(b)
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    assert ck["restored3"]["mini_step"] == 1
    for k, v in ck["full4"].items():
        assert ck["resumed4"][k].tobytes() == v.tobytes(), k


def _one_device_state(tt, st):
    leaves = [x for _, x in trainer._leaves(tt)]
    return {"params": {"/".join(map(str, p)): x.detach().numpy()
                       for p, x in tree.flatten(tt) if x is not None},
            "moments": [{k: int(v) if k == "step" else v.numpy()
                         for k, v in st.adamw.state[x].items()}
                        for x in leaves],
            "acc": [a.numpy() for a in st.acc], "mini_step": st.mini_step,
            "updates": st.updates}


def _equal_states(got, want, exact):
    assert (got["mini_step"], got["updates"]) == (want["mini_step"],
                                                  want["updates"])
    pairs = [(got["params"][k], v) for k, v in want["params"].items()]
    pairs += list(zip(got["acc"], want["acc"]))
    for a, b in zip(got["moments"], want["moments"]):
        assert sorted(a) == sorted(b)
        pairs += [(a[n], b[n]) for n in b]
    for g, w in pairs:
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=LEAF_RTOL, atol=LEAF_ATOL)


def test_mesh_checkpoint_loads_on_one_device(runs):
    """The {2, 2} save is the file one device writes: a one-device restore
    holds the mesh's whole leaves, moments and accumulators, bit for bit."""
    tcfg = trainer.TrainConfig(**dict(W.TRAIN_BASE, grad_accum_steps=2,
                                      loss_chunk=8))
    params = tree.to_torch(tree.map_tree(np.copy, runs.payload["r4"]),
                           device="cpu")
    tt, _, _, st = trainer.init_train_state(params, tcfg)
    tt, st, step = checkpoint.CheckpointManager(
        runs.payload["ckpt_dir"]).restore(tt, st)
    assert step == 3
    _equal_states(_one_device_state(tt, st), runs.ranks[0][0]["ckpt"]["at3"],
                  exact=True)


def test_one_device_checkpoint_loads_on_the_mesh(runs):
    want = _one_device_state(*runs.one)
    _equal_states(runs.ranks[0][0]["ckpt"]["from_one"], want, exact=True)
    # and the one-device state after 3 micro-steps is the mesh's
    _equal_states(runs.ranks[0][0]["ckpt"]["at3"], want, exact=False)


@pytest.mark.parametrize("cli", ["cli", "vila"])
def test_cli_on_the_mesh_logs_the_one_device_metrics(runs, cli):
    """Rank 0 writes metrics.jsonl, the adapter and (VILA) the component
    dirs; the metrics are the one-device run's at the same global batch."""
    got = _metrics(runs.tmp / f"{cli}_mesh" / "metrics.jsonl")
    want = _metrics(runs.tmp / f"{cli}_one" / "metrics.jsonl")
    steps = {"cli": {1, 2, 3}, "vila": {1, 2}}[cli]
    assert set(got) == set(want) == steps
    for step in steps:
        for key in ("loss", "alignment", "kl"):
            np.testing.assert_allclose(got[step][key], want[step][key],
                                       rtol=LOSS_RTOL, err_msg=f"{step} {key}")
        np.testing.assert_allclose(got[step]["grad_norm"],
                                   want[step]["grad_norm"], rtol=NORM_RTOL)
    with np.load(runs.tmp / f"{cli}_mesh" / "adapter.npz") as a, np.load(
            runs.tmp / f"{cli}_one" / "adapter.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=LEAF_RTOL,
                                       atol=LEAF_ATOL, err_msg=k)
    if cli == "vila":
        assert (runs.tmp / "vila_mesh" / "components").is_dir()


def test_ranks_import_neither_jax_nor_the_reference(runs):
    for _, loaded in runs.ranks:
        assert not [m for m in loaded if m.startswith("halva_tpu")
                    and not m.startswith("halva_tpu_torch")], loaded
