"""Process-group ranks for the port's mesh tests (not a test module).

`World` spawns n processes that join one gloo group on the CPU and run a
function of this module; each imports torch and the port, never JAX or the
reference, and returns numpy. The cases are listed here so that the test
process computes the references of the same list.
"""

import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

EOS = 2
MAX_NEW = 12

# (name, mesh (data, model), tree, inputs, what, generate kwargs, env)
GEN_CASES = [
    ("data_fp32", (4, 1), "fp32", "std", "greedy", {}, {}),
    ("data_bf16", (4, 1), "bf16", "std", "greedy", {"max_new_tokens": 14},
     {}),
    ("tp_fp32", (2, 2), "fp32", "std", "greedy", {}, {}),
    ("tp4_fp32", (1, 4), "fp32", "std", "greedy", {}, {}),
    ("tp_int8", (2, 2), "int8", "std", "greedy", {"max_new_tokens": 16}, {}),
    ("tp_int4", (2, 2), "int4tp2", "std", "greedy", {"max_new_tokens": 20},
     {}),
    ("tp_int4_kv8", (2, 2), "int4tp2", "std", "greedy",
     {"max_new_tokens": 28, "kv_quant": "int8"}, {}),
    ("gather_nf4", (2, 2), "nf4", "std", "greedy", {}, {}),
    ("gather_int4", (2, 2), "int4", "std", "greedy", {"max_new_tokens": 32},
     {}),
    ("gather_propagate", (2, 2), "fp32", "std", "greedy", {},
     {"HALVA_TP_IMPL": "propagate"}),
    ("sample_data", (4, 1), "fp32", "same", "greedy",
     {"temperature": 1.0, "seed": 7}, {}),
    ("sample_tp", (2, 2), "fp32", "same", "greedy",
     {"temperature": 1.0, "seed": 7}, {}),
    ("beam_data", (4, 1), "fp32", "std", "beam", {"num_beams": 2}, {}),
    ("runner_tp", (2, 2), "fp32", "text", "runner", {}, {}),
    ("runner_beam_data", (4, 1), "fp32", "text", "runner",
     {"num_beams": 2}, {}),
    ("graph_true_gloo", (2, 2), "fp32", "std", "greedy", {"graph": True},
     {}),
]


def port_trees(np_tree):
    """The tests' port trees, quantized by the port from one fp32 tree."""
    from halva_tpu_torch import tree
    from halva_tpu_torch.ops import quant, w4_matmul

    fp32 = tree.to_torch(np_tree, device="cpu")
    bf16 = tree.map_tree(
        lambda t: t.bfloat16() if t.is_floating_point() else t, fp32)
    return {"fp32": fp32, "bf16": bf16, "int8": quant.quantize_params(fp32),
            "nf4": quant.quantize_params(fp32, bits=4),
            "int4": w4_matmul.quantize_params_int4(fp32),
            "int4tp2": w4_matmul.quantize_params_int4(fp32, tp=2)}


class WordTok:
    """A word-level tokenizer of a fixed vocabulary: the runner's
    interface (call -> input_ids with a BOS, decode, bos/eos ids)."""

    bos_token_id = 1
    eos_token_id = EOS

    def __init__(self, vocab=256):
        self.vocab = vocab

    def _id(self, word):
        return 5 + sum(map(ord, word)) % (self.vocab - 5)

    def __call__(self, text):
        ids = [self.bos_token_id] + [self._id(w) for w in text.split()]
        return SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids if i > 4)


def text_requests(runner):
    return [runner.EvalRequest(question_id=i, image_path=None,
                               text="Describe item %d in detail." % i
                               + " Please." * (i % 3))
            for i in range(6)]


def runner_texts(params, cfg, mesh, kw):
    from halva_tpu_torch.evals import runner

    gen = runner.BatchedGenerator(
        params, cfg, WordTok(), SimpleNamespace(crop_size=28), batch_size=4,
        max_new_tokens=6, prompt_bucket=16, mesh=mesh, **kw)
    return gen.run(text_requests(runner))


@contextlib.contextmanager
def case_env(env, tree_name):
    """The case's environment, and W8A8 off for the int8 tree (manual TP's
    W8A8 is a requantization: its own case)."""
    from halva_tpu_torch.ops import quant

    old_env = {k: os.environ.get(k) for k in env}
    old_w8 = quant.w8a8_enabled()
    os.environ.update(env)
    if tree_name == "int8":
        quant.set_w8a8(False)
    try:
        yield
    finally:
        quant.set_w8a8(old_w8)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_case(case, params, cfg, inputs, mesh=None):
    """One case on one device (mesh None) or on this rank's mesh: (tokens,
    num) as numpy, a list of texts, or the ValueError's text."""
    from halva_tpu_torch.ops.beam import generate_beam
    from halva_tpu_torch.ops.generate import generate

    name, _, tree_name, _, what, kw, env = case
    kw = dict(kw)
    max_new = kw.pop("max_new_tokens", MAX_NEW)
    with case_env(env, tree_name), torch.inference_mode():
        if what == "runner":
            return runner_texts(params, cfg, mesh, kw)
        ids, ims, lens = (torch.from_numpy(x) for x in inputs)
        try:
            if what == "beam":
                toks, num = generate_beam(params, cfg, ids, ims, lens, max_new,
                                          EOS, mesh=mesh, **kw)
            else:
                toks, num = generate(params, cfg, ids, ims, lens, max_new,
                                     EOS, mesh=mesh, **kw)
        except ValueError as e:
            return str(e)
    return toks.numpy(), num.numpy()


def generate_cases(rank, world, payload):
    from halva_tpu_torch.config import llava_config_from_dict
    from halva_tpu_torch.parallel.mesh import make_mesh

    cfg = llava_config_from_dict(payload["cfg"])
    trees = port_trees(payload["tree"])
    meshes, out = {}, {}
    for case in GEN_CASES:
        dm = case[1]
        if dm not in meshes:
            meshes[dm] = make_mesh(data=dm[0], model=dm[1], device="cpu")
        out[case[0]] = run_case(case, trees[case[2]], cfg,
                                payload["inputs"][case[3]], meshes[dm])
    out["w8a8_ksplit"] = w8a8_ksplit(payload["ksplit"], meshes[(2, 2)])
    return out


def w8a8_ksplit(xw, mesh):
    """W8A8's row-split dense on the model axis: each rank quantizes its
    K shard of x per token, then the all-reduce."""
    from halva_tpu_torch.models.llama import dense
    from halva_tpu_torch.ops import quant
    from halva_tpu_torch.parallel.mesh import all_reduce

    x, w = (torch.from_numpy(a) for a in xw)
    p = quant.quantize_params({"d": {"kernel": w}})["d"]
    n, r = mesh.size("model"), mesh.index("model")
    k = x.shape[1] // n
    old = quant.w8a8_enabled()
    quant.set_w8a8(True)
    try:
        y = dense(x[:, r * k:(r + 1) * k].contiguous(),
                  {"kernel_q": p["kernel_q"][r * k:(r + 1) * k],
                   "kernel_scale": p["kernel_scale"]})
        return all_reduce(y, mesh.group("model")).numpy()
    finally:
        quant.set_w8a8(old)


def cp_cases(rank, world, payload):
    """context_parallel_attention of each case on its mesh: the output and
    the grads of sum(out * w) in q, k and v."""
    from halva_tpu_torch.parallel.context import context_parallel_attention
    from halva_tpu_torch.parallel.mesh import axes_mesh

    meshes, out = {}, {}
    for name, shape, batch_axis, case in payload:
        if shape not in meshes:
            meshes[shape] = axes_mesh(dict(shape), device="cpu")
        q, k, v = (torch.from_numpy(case[n]).requires_grad_()
                   for n in ("q", "k", "v"))
        seg = torch.from_numpy(case["seg"])
        o = context_parallel_attention(
            meshes[shape], q, k, v, seg, seg, batch_axis=batch_axis,
            sliding_window=case["window"])
        (o * torch.from_numpy(case["w"])).sum().backward()
        out[name] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    return out


def cli_rank(rank, world, payload):
    """The eval CLI on this rank, with config_from_hf mapped to the tiny
    widths (the test's monkeypatch, made here); its environment as under
    torchrun."""
    from halva_tpu_torch import config as tconfig
    from halva_tpu_torch.evals import cli
    from halva_tpu_torch.models import builder

    real = builder.config_from_hf
    llm = tconfig.LlamaConfig(**payload["llm"])
    vision = tconfig.ViTConfig(**payload["vision"])
    builder.config_from_hf = lambda d: dataclasses.replace(
        real(d), llm=llm, vision=vision)
    os.environ.update(HALVA_QUANT_CACHE="off", RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    cli.main(payload["argv"])
    return None


def _entry(fn, rank, world, tmp, queue, modules):
    try:
        torch.set_num_threads(1)
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        # a file store in the world's own directory: no port to race for
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=120))
        out = fn(rank, world, payload)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in modules)
        queue.put((rank, "ok", (out, loaded)))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """`world` spawned ranks of fn(rank, world, payload), started at once;
    `results()` waits for them: [(result, modules of jax or the reference
    that the rank loaded)] by rank. The payload goes through a file: a
    large one in the spawn arguments would start the ranks one after
    another (each reads its arguments only once it has imported torch)."""

    def __init__(self, fn, world, payload):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.tmp = tempfile.mkdtemp(prefix="mesh_world_")
        with open(os.path.join(self.tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        self.procs = [ctx.Process(
            target=_entry, args=(fn, r, world, self.tmp, self.queue,
                                 ("jax", "jaxlib", "halva_tpu")))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout=300):
        got, errors = {}, []
        try:
            for _ in self.procs:
                rank, status, out = self.queue.get(timeout=timeout)
                if status == "ok":
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in self.procs:
                p.join(timeout=0 if errors else 30)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            shutil.rmtree(self.tmp, ignore_errors=True)
        if errors:
            raise AssertionError("\n".join(errors))
        return [got[r] for r in range(len(self.procs))]


# ---- training on the mesh (tests/test_torch_mesh_train.py) -----------------

# the TrainConfig of every step case: a constant learning rate, so that the
# first update moves the LoRA leaves; remat on
TRAIN_BASE = dict(learning_rate=1e-3, lr_schedule="constant",
                  grad_accum_steps=1, num_train_steps=10, remat=True)
# (name, mesh (data, model), batch kind, policy, TrainConfig fields)
TRAIN_CASES = [
    ("d4", (4, 1), "rows", "r4", {}),
    ("d4_chunk", (4, 1), "rows", "r4", {"loss_chunk": 8}),
    ("tp", (2, 2), "rows", "r4", {}),
    ("tp_chunk", (2, 2), "rows", "r4", {"loss_chunk": 8}),
    ("packed_d4", (4, 1), "packed", "r4", {}),
    ("packed_tp", (2, 2), "packed", "r4", {}),
    ("adamw8bit_tp", (2, 2), "rows", "r32",
     {"optim": "adamw8bit", "loss_chunk": 8}),
    ("accum_tp", (2, 2), "accum", "r4",
     {"grad_accum_steps": 2, "loss_chunk": 8}),
]
MAX_SAMPLES = 4  # the packed batch's sample slots


def _flat(t):
    from halva_tpu_torch import tree

    return {"/".join(map(str, p)): x.detach().float().numpy().copy()
            for p, x in tree.flatten(t) if x is not None}


def train_case(case, payload, mesh=None):
    """One step case on this rank's shards (`mesh`) or on one device: the
    first micro-step's loss parts and whole LoRA grads
    (`loss_and_grads`), then the micro-steps' metrics and the whole
    trainable leaves after them, as numpy."""
    from halva_tpu_torch import tree
    from halva_tpu_torch.config import llava_config_from_dict
    from halva_tpu_torch.parallel import partition
    from halva_tpu_torch.train import trainer

    name, _, kind, policy, kw = case
    cfg = llava_config_from_dict(payload["cfg"])
    params = tree.to_torch(tree.map_tree(np.copy, payload[policy]),
                           device="cpu")
    tcfg = trainer.TrainConfig(**dict(TRAIN_BASE, **kw))
    trainable, frozen, opt, st = trainer.init_train_state(params, tcfg,
                                                          mesh=mesh)
    packed = kind == "packed"
    if packed:
        step, _ = trainer.packed_dpa_step_fns(cfg, tcfg, opt, MAX_SAMPLES,
                                              mesh=mesh)
    else:
        step, _ = trainer.dpa_step_fns(cfg, tcfg, opt, mesh=mesh)
    batches = {"rows": payload["batches"][:1], "accum": payload["batches"],
               "packed": [payload["packed"]]}[kind]

    def rows(b):
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        if mesh is None:
            return b
        partition.check_train_rows(b, mesh, packed)
        return (partition.shard_packed_batch(b, mesh) if packed
                else partition.shard_batch(b, mesh))

    whole = (lambda t: t) if mesh is None else opt.layout.whole
    _, parts, grads = step.loss_and_grads(trainable, frozen, None,
                                          rows(batches[0]))
    out = {"parts": [float(x) for x in parts], "grads": _flat(whole(grads)),
           "metrics": []}
    for b in batches:
        trainable, st, m = step(trainable, frozen, None, st, rows(b))
        out["metrics"].append([float(x) for x in m])
    out["params"] = _flat(whole(trainable))
    out["updates"] = st.updates
    return out


def ckpt_case(payload, mesh):
    """AdamW at grad_accum 2 on the {2, 2} mesh: 3 micro-steps, a save at 3
    (the accumulators mid-cycle), a 4th; then a fresh state restored from
    step 3 runs the 4th again; and the one-device checkpoint of the payload
    restored here. Whole leaves, moments and accumulators as numpy."""
    from halva_tpu_torch import tree
    from halva_tpu_torch.config import llava_config_from_dict
    from halva_tpu_torch.parallel import partition
    from halva_tpu_torch.train import checkpoint, trainer

    cfg = llava_config_from_dict(payload["cfg"])
    tcfg = trainer.TrainConfig(**dict(TRAIN_BASE, grad_accum_steps=2,
                                      loss_chunk=8))
    batches = [partition.shard_batch(
        {k: torch.from_numpy(v) for k, v in b.items()}, mesh)
        for b in payload["batches"] * 2]

    def fresh():
        params = tree.to_torch(tree.map_tree(np.copy, payload["r4"]),
                               device="cpu")
        tt, tf, opt, st = trainer.init_train_state(params, tcfg, mesh=mesh)
        step, _ = trainer.dpa_step_fns(cfg, tcfg, opt, mesh=mesh)
        return tt, tf, st, step

    def state(tt, st):
        def whole(t, sp):
            return partition.whole_leaf(t, sp, mesh).numpy()

        leaves = [x for _, x in trainer._leaves(tt)]
        moments = [{k: int(v) if k == "step" else whole(v, sp)
                    for k, v in st.adamw.state[x].items()}
                   for x, sp in zip(leaves, st.specs)]
        return {"params": _flat(st.layout.whole(tt)), "moments": moments,
                "acc": [whole(a, sp) for a, sp in zip(st.acc, st.specs)],
                "mini_step": st.mini_step, "updates": st.updates}

    mgr = checkpoint.CheckpointManager(payload["ckpt_dir"])
    tt, tf, st, step = fresh()
    for b in batches[:3]:
        tt, st, _ = step(tt, tf, None, st, b)
    mgr.save(3, tt, st)
    out = {"at3": state(tt, st)}
    tt, st, _ = step(tt, tf, None, st, batches[3])
    out["full4"] = _flat(st.layout.whole(tt))
    tt, tf, st, step = fresh()
    tt, st, got = mgr.restore(tt, st)
    out["restored3"] = state(tt, st)
    tt, st, _ = step(tt, tf, None, st, batches[3])
    out["resumed4"] = _flat(st.layout.whole(tt))
    tt, tf, st, step = fresh()
    tt, st, _ = checkpoint.CheckpointManager(payload["ckpt_one"]).restore(
        tt, st)
    out["from_one"] = state(tt, st)
    return out


def cli_case(rank, world, argv, vila_cfg=None):
    """The train CLI (or, with `vila_cfg`, the VILA CLI on that preset) on
    this rank, its environment as torchrun sets it."""
    from halva_tpu_torch.config import PRESETS, llava_config_from_dict
    from halva_tpu_torch.train import run, vila

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if vila_cfg is None:
        run.main(argv)
    else:
        PRESETS["vila-13b-384"] = llava_config_from_dict(vila_cfg)
        vila.main(argv)


def train_cases(rank, world, payload):
    """Every case of the mesh train test on this rank: the step cases, the
    checkpoint case on {2, 2}, the train CLI and the VILA CLI."""
    from halva_tpu_torch.parallel.mesh import make_mesh

    meshes, out = {}, {}
    for case in TRAIN_CASES:
        dm = case[1]
        if dm not in meshes:
            meshes[dm] = make_mesh(data=dm[0], model=dm[1], device="cpu")
        out[case[0]] = train_case(case, payload, meshes[dm])
    out["ckpt"] = ckpt_case(payload, meshes[(2, 2)])
    cli_case(rank, world, payload["cli_argv"])
    cli_case(rank, world, payload["vila_argv"], payload["vila_cfg"])
    return out
