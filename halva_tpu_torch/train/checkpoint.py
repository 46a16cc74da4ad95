"""Checkpoint/resume + adapter export.

Counterpart of halva_tpu/train/checkpoint.py, covering the same save
formats (SURVEY.md §5):
(a) LoRA adapter + non-lora trainables (train_halva.py:1230-1240) —
    `save_adapter`/`load_adapter` as a flat npz, the reference's file
    format, so an adapter saved by either package loads in the other;
(b) full train state for resume (HF Trainer checkpoint-* dirs,
    train_halva.py:1222-1225) — `CheckpointManager` with step discovery
    and retention;
(c) a whole param tree (a merged model for eval, a base for training) —
    `save_params`/`load_params`.

The reference writes (b) and (c) with orbax, which needs JAX. Here both are
the tree file of utils/treecache.py (`write_tree`/`read_tree`: skeleton,
dtypes, one npz entry per leaf), written atomically, so that neither needs
anything beyond numpy. A directory written by one package is not read by
the other; the trees in them are equal.

A bf16 adapter leaf is written as 2-byte void from a uint16 view of the
tensor: the payload and shape np.savez writes for the reference's
ml_dtypes.bfloat16 array. Any 2-byte void entry reads back as bf16 through
int16 (`tree.to_torch`), so nothing here needs ml_dtypes.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from halva_tpu_torch import tree
from halva_tpu_torch.parallel import partition
from halva_tpu_torch.utils import treecache
from halva_tpu_torch.utils.logging import is_main_process

Params = Dict[str, Any]

PARAMS_FILE = "params.npz"
STATE_FILE = "state.npz"

_BF16_ON_DISK = np.dtype("V2")


# ---- (a) adapters ---------------------------------------------------------


def _adapter_array(v) -> np.ndarray:
    a = np.asarray(v)
    # an ml_dtypes.bfloat16 array (lora_state_dict where ml_dtypes is
    # installed, or the reference's): its bytes as 2-byte void
    return a.view(_BF16_ON_DISK) if a.dtype.name == "bfloat16" else a


def save_adapter(path: str, adapter_sd: Dict[str, np.ndarray]) -> None:
    """Flat adapter-only export (reference adapter_model.bin equivalent),
    from `lora.lora_state_dict`; bf16 goes to disk as 2-byte void."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: _adapter_array(v) for k, v in adapter_sd.items()})


def load_adapter(path: str) -> Dict[str, np.ndarray]:
    """The adapter as host numpy arrays. A 2-byte void entry ('<V2' from
    the reference, '|V2' from here) is bf16: it stays void here, and
    `lora.load_lora_state_dict` (through `tree.to_torch`) reads it as
    torch.bfloat16 through int16."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---- (c) whole param trees -------------------------------------------------


def save_params(directory: str, params: Params) -> None:
    """The tree (nested dicts and lists of tensors on any device) as one
    tree file in `directory`, written atomically."""
    os.makedirs(directory, exist_ok=True)
    treecache.write_tree(os.path.join(directory, PARAMS_FILE), params)


def is_params_dir(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, PARAMS_FILE))


def load_params(directory: str, like: Optional[Params] = None,
                device="cuda") -> Params:
    """like=None restores the tree exactly as saved (structure, dtypes,
    shapes), each leaf put on `device` (the card unless the caller names
    the CPU) as its entry is read, so that the host holds one leaf at a
    time. With `like`, the tree must have its paths and shapes, and each
    leaf takes its template's dtype."""
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {PARAMS_FILE} in {directory}")
    params, _ = treecache.read_tree(path, put=lambda t: t.to(device))
    if like is None:
        return params
    got = dict(tree.flatten(params))
    want = dict(tree.flatten(like))
    if set(got) != set(want):
        raise ValueError(
            f"{directory}: tree differs from the template: "
            f"{sorted(set(got) ^ set(want), key=str)[:5]}")
    for p, t in want.items():
        if tuple(got[p].shape) != tuple(t.shape):
            raise ValueError(f"{directory}: {p} has shape "
                             f"{tuple(got[p].shape)}, not {tuple(t.shape)}")
    return _cast_like(params, like)


def _cast_like(params, like):
    if isinstance(params, dict):
        return {k: _cast_like(v, like[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_cast_like(v, w) for v, w in zip(params, like)]
    return params.to(like.dtype)


# ---- (b) train state --------------------------------------------------------


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _trainable_leaves(trainable: Params) -> List[Tuple[str, torch.Tensor]]:
    return [(_key(p), x) for p, x in tree.flatten(trainable)
            if x is not None]


class CheckpointManager:
    """save/restore (trainable, opt_state, step), one directory per step
    (`<directory>/<step>/state.npz`) with the reference's step discovery
    (the largest complete step) and retention (the newest `max_to_keep`).

    `opt_state` is the trainer's DPAOptimizer (train/trainer.py), whose
    state is saved whole, as optax's MultiSteps state is in the
    reference's save: per trainable leaf, keyed by the leaf's path in the
    trainable tree, the optimizer's state (AdamW's exp_avg, exp_avg_sq and
    step; under optim="adamw8bit" optim8bit's m_q/m_s/v_q/v_s, or m/v for a
    small leaf, and step) and the gradient accumulators; the optim kind,
    the schedule's update count and the mini-step in the meta record. A
    checkpoint of one optim kind is refused under the other. A save is
    written under a temporary name and renamed, so an interrupted save
    leaves the last complete step readable.

    On a train mesh (the optimizer's TrainLayout) the file is the one a
    single device writes: every rank takes part in gathering the whole
    leaves, their AdamW moments and accumulators (the 8-bit moments are
    whole already), rank 0 writes, and the ranks meet before the next
    step; a restore reads the whole leaves and each rank keeps its shards.
    A checkpoint of either kind of run restores in the other."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def all_steps(self) -> List[int]:
        return sorted(
            int(n) for n in os.listdir(self._dir)
            if re.fullmatch(r"\d+", n)
            and os.path.isfile(os.path.join(self._dir, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainable: Params, opt_state) -> bool:
        """Write `step`; returns whether it did. As the reference's orbax
        manager, a step at or below the latest saved one is not written
        again (the train loop's closing save after a save_steps save, or
        after a resume that had nothing left to run)."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        leaves = _trainable_leaves(trainable)
        moments = opt_state.adamw.state
        mesh = opt_state.mesh
        sharded = opt_state.LEAF_STATE[opt_state.tcfg.optim]

        def whole(t, spec):
            return t if mesh is None else partition.whole_leaf(t, spec, mesh)

        state: Dict[str, Dict[str, torch.Tensor]] = {"params": {}}
        for (key, x), spec in zip(leaves, opt_state.specs):
            state["params"][key] = whole(x, spec)
            for name, v in moments.get(x, {}).items():
                state.setdefault(name, {})[key] = (
                    whole(v, spec) if name in sharded else v)
        if opt_state.acc is not None:
            state["acc"] = {key: whole(a, spec) for (key, _), a, spec in
                            zip(leaves, opt_state.acc, opt_state.specs)}
        if mesh is None or is_main_process():
            self._write(step, state, opt_state)
        if mesh is not None:
            dist.barrier()
        return True

    def _write(self, step: int, state, opt_state) -> None:
        tmp = os.path.join(self._dir, f".{step}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        treecache.write_tree(
            os.path.join(tmp, STATE_FILE), state, step=step,
            optim=opt_state.tcfg.optim,
            updates=opt_state.scheduler.last_epoch,
            mini_step=opt_state.mini_step)
        final = self._step_dir(step)
        if os.path.isdir(final):  # a step dir left without its file
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self._keep] if self._keep else []:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    @torch.no_grad()
    def restore(self, trainable_like: Params, opt_state_like,
                step: Optional[int] = None) -> Tuple[Params, Any, int]:
        """Write the saved step into the given trainable leaves and
        optimizer, in place, on their devices; returns them and the
        step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        state, meta = treecache.read_tree(
            os.path.join(self._step_dir(step), STATE_FILE))
        opt = opt_state_like
        saved = meta.get("optim", "adamw")
        if saved != opt.tcfg.optim:
            raise ValueError(
                f"checkpoint {step} holds optim={saved!r} state; this run's "
                f"optimizer is optim={opt.tcfg.optim!r}")
        leaves = _trainable_leaves(trainable_like)
        if set(state["params"]) != {k for k, _ in leaves}:
            raise ValueError(
                f"checkpoint {step} holds other trainable leaves: "
                f"{sorted(set(state['params']) ^ {k for k, _ in leaves})[:5]}")
        names = [n for n in state if n not in ("params", "acc")]
        sharded = opt.LEAF_STATE[opt.tcfg.optim]

        def mine(t, spec, x):
            if opt.mesh is None:
                return t.to(x.device)
            return partition.local_shard(t, spec, opt.mesh)

        for (key, x), spec in zip(leaves, opt.specs):
            x.copy_(mine(state["params"][key], spec, x))
            st = {n: state[n][key] for n in names if key in state[n]}
            if st:
                # the step count stays on the host, as the optimizers keep it
                opt.adamw.state[x] = {
                    n: v.clone() if n == "step" else
                    mine(v, spec, x) if n in sharded else v.to(x.device)
                    for n, v in st.items()}
            else:
                opt.adamw.state.pop(x, None)
        if "acc" in state:
            opt.acc = [mine(state["acc"][key], spec, x)
                       for (key, x), spec in zip(leaves, opt.specs)]
        elif opt.acc is not None:
            for a in opt.acc:
                a.zero_()
        opt.mini_step = int(meta["mini_step"])
        sched = opt.scheduler
        sched.last_epoch = int(meta["updates"])
        lrs = [base * fn(sched.last_epoch)
               for fn, base in zip(sched.lr_lambdas, sched.base_lrs)]
        for group, lr in zip(opt.adamw.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
        return trainable_like, opt, step

    def close(self):
        pass
