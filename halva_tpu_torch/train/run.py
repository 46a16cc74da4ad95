"""HALVA DPA training entry point (the reference's train_halva.py train()).

Counterpart of halva_tpu/train/run.py with the same RunConfig, flow and
semantics, on one card (`device`, the card unless the caller names the
CPU) or on a device mesh of one process a card (--mesh-data N --mesh-model
M under `torchrun --nproc-per-node N*M`). Orchestration only — all device
math lives in trainer.py. The flow (reference
llava/train/train_halva.py:1179-1243):
  build policy (base + LoRA) and frozen reference model -> dataset ->
  train loop (grad-accum, cosine lr, checkpoint/resume) -> adapter save.

On a mesh every rank builds the whole policy and cuts its shards
(trainer.init_train_state(mesh=)), reads the same index stream and collates
the same global batch as the reference's one process does (so padding is to
the longest row of the global batch), and keeps its rows
(partition.shard_batch / shard_packed_batch); rank 0 writes the logs, the
metrics, the checkpoints and the exports, which are the files one card
writes.

Differences by design:
- the frozen ref model is the policy's frozen tree (trainer.ref_model_tree),
  not a second engine;
- resume is a CheckpointManager step restore (train/checkpoint.py), not HF
  checkpoint dirs; it restores the optimizer in place.

    python -m halva_tpu_torch.train.run --model llava-v1.5-7b \\
        --model-path BASE_DIR --data-path data.json \\
        --ref-data-path ref.json --image-folder imgs --output-dir out

(`--device cpu` runs on the host; HALVA_TOKENIZER names the tokenizer.)
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Optional, Tuple

import torch

from halva_tpu_torch import tree
from halva_tpu_torch.config import LlavaConfig, PRESETS
from halva_tpu_torch.parallel import partition
from halva_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from halva_tpu_torch.train import checkpoint as ckpt_lib
from halva_tpu_torch.train import lora as lora_lib
from halva_tpu_torch.train import sampler as sampler_lib
from halva_tpu_torch.train import trainer as trainer_lib
from halva_tpu_torch.train.data import HallDataset, collate
from halva_tpu_torch.utils.logging import (
    MetricsLogger,
    StepTimer,
    is_main_process,
    log0,
)


@dataclasses.dataclass
class RunConfig:
    model: str = "llava-v1.5-7b"  # preset name
    model_path: Optional[str] = None  # save_params dir of the base params
    output_dir: str = "out/halva"
    data_path: str = "data/data.json"
    ref_data_path: Optional[str] = "data/ref_data.json"
    image_folder: str = ""
    # recipe (src/hallava_7b.sh)
    epochs: float = 1.0
    max_steps: Optional[int] = None  # hard micro-step cap (HF max_steps)
    per_device_batch: int = 4
    grad_accum_steps: int = 4
    learning_rate: float = 5e-6
    mm_projector_lr: Optional[float] = None
    optim: str = "adamw"  # adamw | adamw8bit (train/optim8bit.py)
    loss_alpha: float = 0.4
    lora_r: int = 128
    lora_alpha: float = 256.0
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    max_length: int = 2048
    seed: int = 42
    save_steps: int = 50000
    log_every: int = 1
    dtype: str = "bfloat16"
    mesh_data: Optional[int] = None  # None: the processes over mesh_model
    mesh_model: int = 1
    resume: bool = True
    metrics_path: Optional[str] = None
    # VILA-variant knobs (train/vila.py; reference vila/train/
    # train_halva.py:340-346 component flags + builder.py:43-51 RoPE ext)
    tune_language_model: bool = False
    tune_vision_tower: bool = False
    tune_mm_projector: bool = False
    model_max_length: Optional[int] = None  # RoPE linear ctx extension
    save_component_dirs: bool = False  # llm/ vision_tower/ mm_projector/
    # vocab extension (reference initialize_vision_tokenizer,
    # llava/model/llava_arch.py:398-440: add <im_start>/<im_end> (and
    # optionally <im_patch>) with mean-init embedding rows)
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    # sequence packing (train/pack.py): fixed rows of several documents
    pack: bool = False
    pack_rows: Optional[int] = None
    pack_ref_rows: Optional[int] = None
    pack_seq_len: Optional[int] = None
    device: str = "cuda"  # the card unless the caller names the CPU


def mesh_axes(rcfg: RunConfig) -> Optional[Tuple[int, int]]:
    """(data, model) of the run's mesh, or None for a run of one process:
    the world is WORLD_SIZE (torchrun's), 1 without it. A mesh_model that
    does not divide the world, or a shape whose size is not the world's,
    raises ValueError: called before anything loads."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    model = rcfg.mesh_model
    if model < 1 or world % model:
        raise ValueError(f"mesh_model={model} does not divide the {world} "
                         "processes of this run (one process a card, under "
                         "torchrun --nproc-per-node)")
    data = rcfg.mesh_data or world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != the {world} processes of "
                         "this run (one process a card, under torchrun "
                         "--nproc-per-node)")
    return None if world == 1 else (data, model)


def build_models(rcfg: RunConfig, cfg: LlavaConfig, tokenizer=None):
    """Base params (from a save_params dir, else random init for smoke
    runs) + LoRA policy + frozen reference copy, on `rcfg.device`. Returns
    (policy, base, cfg) — cfg may gain vocab rows when
    mm_use_im_start_end/mm_use_im_patch_token extend the tokenizer
    (models/vocab.py; reference llava_arch.py:398-440). The random init
    draws from a seeded torch.Generator, not JAX's PRNG: the values differ
    from the reference's, the tree's structure, shapes and dtypes do not."""
    dtype = torch.bfloat16 if rcfg.dtype == "bfloat16" else torch.float32
    device = torch.device(rcfg.device)
    if rcfg.model_path:
        # the preset's tree on the meta device: the template the saved
        # tree must match, and the dtype each leaf is restored in
        like = tree.init_params(cfg, torch.Generator().manual_seed(0),
                                dtype, device="meta")
        base = ckpt_lib.load_params(rcfg.model_path, like, device=device)
    else:
        log0("no model_path given — random init (smoke mode)")
        base = tree.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), dtype,
            device=device)
    if tokenizer is not None and (
        rcfg.mm_use_im_start_end or rcfg.mm_use_im_patch_token
    ):
        from halva_tpu_torch.models.vocab import (
            extend_tokenizer_and_embeddings,
        )

        base, cfg, n_new = extend_tokenizer_and_embeddings(
            base,
            cfg,
            tokenizer,
            mm_use_im_patch_token=rcfg.mm_use_im_patch_token,
            mm_use_im_start_end=rcfg.mm_use_im_start_end,
        )
        if n_new:
            log0("vocab extended by %d tokens (mean-init rows)", n_new)
    policy = lora_lib.add_lora(
        base,
        torch.Generator(device=device).manual_seed(rcfg.seed),
        rank=rcfg.lora_r,
        alpha=rcfg.lora_alpha,
    )
    return policy, base, cfg  # ref model shares the base tree (frozen)


def _any_rank(flag: bool, mesh) -> bool:
    """A stop flag that holds on every rank of the mesh if on any (the
    ranks meet in every step's collectives, so they stop together)."""
    if mesh is None:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    torch.distributed.all_reduce(t)
    return bool(t.item() > 0)


def _to_device(host_batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in host_batch.items()}


def train(rcfg: RunConfig, tokenizer, dataset: Optional[Any] = None):
    cfg = PRESETS.get(rcfg.model)
    if not isinstance(cfg, LlavaConfig):
        llava_presets = sorted(
            k for k, v in PRESETS.items() if isinstance(v, LlavaConfig)
        )
        raise ValueError(
            f"unknown LLaVA preset {rcfg.model!r}; choose one of "
            f"{llava_presets}"
        )
    axes = mesh_axes(rcfg)
    mesh = None
    if axes is not None:
        mesh = make_mesh(data=axes[0], model=axes[1], device=rcfg.device)
        log0("mesh: %s", dict(mesh.shape))
    device = torch.device(rcfg.device)

    if rcfg.model_max_length:
        from halva_tpu_torch.train import vila as vila_lib

        cfg = dataclasses.replace(
            cfg,
            llm=vila_lib.context_length_extension(
                cfg.llm, rcfg.model_max_length
            ),
        )

    if dataset is None:
        from halva_tpu_torch.mm_utils import processor_for_vision

        dataset = HallDataset(
            rcfg.data_path,
            rcfg.ref_data_path,
            tokenizer,
            processor_for_vision(cfg.vision),
            image_folder=rcfg.image_folder,
            max_length=rcfg.max_length,
            seed=rcfg.seed,
        )

    n_data = 1 if mesh is None else mesh.size(DATA_AXIS)
    global_batch = rcfg.per_device_batch * n_data
    steps_per_epoch = len(dataset) // global_batch
    num_opt_steps = int(rcfg.epochs * steps_per_epoch / rcfg.grad_accum_steps)
    num_micro_steps = num_opt_steps * rcfg.grad_accum_steps
    if rcfg.pack:
        # a packed batch holds a VARIABLE number of samples (<=
        # global_batch), so the sample-count cadence above undercounts
        # packed steps whenever row capacity binds first. The epoch budget
        # lives in the index stream itself (epoch_indices yields exactly
        # rcfg.epochs passes): run until it drains. The LR schedule keeps
        # the sample-count horizon; the cosine tail flattens at 0 for any
        # overshoot.
        stop_at = rcfg.max_steps or float("inf")
    else:
        stop_at = (
            min(num_micro_steps, rcfg.max_steps)
            if rcfg.max_steps
            else num_micro_steps
        )

    tcfg = trainer_lib.TrainConfig(
        learning_rate=rcfg.learning_rate,
        mm_projector_lr=rcfg.mm_projector_lr,
        optim=rcfg.optim,
        warmup_ratio=rcfg.warmup_ratio,
        weight_decay=rcfg.weight_decay,
        loss_alpha=rcfg.loss_alpha,
        grad_accum_steps=rcfg.grad_accum_steps,
        num_train_steps=num_opt_steps,
    )

    policy, _base, cfg = build_models(rcfg, cfg, tokenizer)
    extra_trainable = []
    if rcfg.tune_language_model:
        extra_trainable.append(r"^llm/")
    if rcfg.tune_vision_tower:
        extra_trainable.append(r"^vision/")
    if rcfg.tune_mm_projector:
        extra_trainable.append(r"^projector/")
    trainable, frozen, optimizer, opt_state = trainer_lib.init_train_state(
        policy, tcfg, extra_trainable=tuple(extra_trainable), mesh=mesh
    )
    # the frozen reference model is DERIVED from `frozen` inside the step
    # (trainer.ref_model_tree) — no second 13GB tree on device. Trainable
    # components beyond LoRA need their ORIGINAL copies overlaid: the step
    # updates the trainable leaves in place, so these must be real copies,
    # or the reference would drift with the policy.
    initial = trainer_lib.combine_params(trainable, frozen)

    def snapshot(t):
        return tree.map_tree(lambda x: x.detach().clone(), t)

    ref_overrides = {}
    if rcfg.mm_projector_lr or rcfg.tune_mm_projector:
        ref_overrides["projector"] = snapshot(initial["projector"])
    if rcfg.tune_vision_tower:
        ref_overrides["vision"] = snapshot(initial["vision"])
    if rcfg.tune_language_model:
        ref_overrides["llm"] = snapshot(initial["llm"])
    ref_params = ref_overrides or None
    del initial, _base, policy

    mesh_kw = {} if mesh is None else {"mesh": mesh}
    if rcfg.pack:
        from halva_tpu_torch.train.pack import PackedDPABatcher

        def _r64(n):
            return -(-n // 64) * 64

        def _rdata(n):
            return -(-n // n_data) * n_data

        pack_seq = rcfg.pack_seq_len or _r64(
            rcfg.max_length + cfg.num_image_tokens - 1
        )
        pack_rows = _rdata(rcfg.pack_rows or global_batch)
        pack_ref_rows = _rdata(rcfg.pack_ref_rows or max(1, pack_rows // 2))
        max_samples = global_batch
        batcher = PackedDPABatcher(
            seq_len=pack_seq,
            pn_rows=pack_rows,
            ref_rows=pack_ref_rows,
            max_samples=max_samples,
            num_image_tokens=cfg.num_image_tokens,
            pad_token_id=0,
            image_shape=(3, cfg.vision.image_size, cfg.vision.image_size),
        )
        log0(
            "packing: %d pn + %d ref rows x %d, <= %d samples/step",
            pack_rows, pack_ref_rows, pack_seq, max_samples,
        )
        step_fn, _ = trainer_lib.packed_dpa_step_fns(
            cfg, tcfg, optimizer, max_samples=max_samples, **mesh_kw
        )
    else:
        batcher = None
        step_fn, _ = trainer_lib.dpa_step_fns(cfg, tcfg, optimizer, **mesh_kw)

    mgr = ckpt_lib.CheckpointManager(
        os.path.join(rcfg.output_dir, "checkpoints")
    )
    start_step = 0
    if rcfg.resume and mgr.latest_step() is not None:
        # restores into the trainable leaves and the optimizer, in place
        trainable, opt_state, start_step = mgr.restore(
            trainable, opt_state
        )
        log0("resumed from step %d", start_step)

    metrics = MetricsLogger(
        rcfg.metrics_path
        or os.path.join(rcfg.output_dir, "metrics.jsonl")
    )
    timer = StepTimer()

    # index stream: modality length grouping, fresh shuffle per epoch;
    # on resume the first `start_step` micro-batches are skipped so a
    # resumed run continues the SAME data stream instead of replaying
    # from sample 0 (HF Trainer skip_first_batches semantics). Every rank
    # of a mesh reads the whole stream and collates the global batch.
    order = sampler_lib.epoch_indices(
        dataset.modality_lengths,
        rcfg.per_device_batch,
        n_data,
        rcfg.epochs,
        seed=rcfg.seed,
    )
    host_batches = sampler_lib.host_shard_batches(order, global_batch, 0, 1)
    if start_step and batcher is None:
        host_batches = itertools.islice(host_batches, start_step, None)

    from halva_tpu_torch.utils.cluster import PreemptionWatcher, WallClockGuard

    watcher = PreemptionWatcher(
        sentinel_path=os.path.join(rcfg.output_dir, "STOP")
    )
    wall = WallClockGuard.from_env()

    from halva_tpu_torch.utils.prefetch import prefetch

    def host_batch_stream():
        """Dataset fetch + collate (or packing) on a background thread (the
        reference's DataLoader workers); the copy to the card stays on this
        one."""
        if batcher is not None:
            def items():
                for batch_idx in host_batches:
                    for i in batch_idx:
                        yield dataset[i]

            stream = batcher.batches(items())
            if start_step:
                # resume skips PACKED batches (micro counts those): packing
                # is deterministic over the same index order, so replaying
                # the first start_step packed batches lands on the sample
                # the interrupted run would see next. An index-level skip
                # would misalign: a packed batch takes a variable number of
                # samples.
                stream = itertools.islice(stream, start_step, None)
            yield from stream
            return
        for batch_idx in host_batches:
            samples = [dataset[i] for i in batch_idx]
            samples = [s for s in samples if s is not None]
            if not samples:
                continue
            yield collate(samples, pad_token_id=0)

    micro = start_step
    t_train0 = time.time()
    for host_batch in prefetch(host_batch_stream(), depth=2):
        if micro >= stop_at:
            break
        if _any_rank(watcher.should_stop(micro) or wall.should_stop(), mesh):
            log0("preemption/timeout: checkpoint + stop at step %d", micro)
            mgr.save(micro, trainable, opt_state)
            break
        if mesh is None:
            batch = _to_device(host_batch, device)
        else:
            partition.check_train_rows(host_batch, mesh, batcher is not None)
            batch = (partition.shard_packed_batch(host_batch, mesh)
                     if batcher is not None
                     else partition.shard_batch(host_batch, mesh))
        trainable, opt_state, m = step_fn(
            trainable, frozen, ref_params, opt_state, batch
        )
        micro += 1
        timer.tick()
        if micro % rcfg.log_every == 0:
            metrics.log(
                micro,
                {
                    "loss": m.loss,
                    "alignment": m.alignment,
                    "kl": m.divergence,
                    "grad_norm": m.grad_norm,
                    "step_time": timer.avg or 0.0,
                },
            )
        if micro % rcfg.save_steps == 0:
            mgr.save(micro, trainable, opt_state)

    if micro == 0:
        raise RuntimeError(
            "no training steps ran: every batch was dropped or the "
            "dataset is smaller than one global batch "
            f"(len(dataset)={len(dataset)}, global_batch={global_batch}). "
            "Dropped samples usually mean the tokenizer cannot be "
            "char-aligned (needs byte-fallback pieces or offsets) — see "
            "train/data.py:token_char_offsets."
        )
    log0("training done in %.1f min", (time.time() - t_train0) / 60)
    mgr.save(micro, trainable, opt_state)

    # adapter-only export (reference adapter + non_lora_trainables save);
    # on a mesh every rank gathers the whole tree and rank 0 writes
    final = trainer_lib.combine_params(trainable, frozen)
    if mesh is not None:
        final = optimizer.layout.whole(final)
    writer = mesh is None or is_main_process()
    adapter = lora_lib.lora_state_dict(final)
    if writer:
        ckpt_lib.save_adapter(
            os.path.join(rcfg.output_dir, "adapter.npz"), adapter
        )
    log0("saved adapter with %d tensors", len(adapter))
    if rcfg.save_component_dirs and writer:
        from halva_tpu_torch.train import vila as vila_lib

        vila_lib.save_components(
            os.path.join(rcfg.output_dir, "components"), final, cfg
        )
        log0("saved per-component checkpoints (llm/vision_tower/"
             "mm_projector)")
    metrics.close()
    mgr.close()
    return final


def parse_args(argv=None) -> RunConfig:
    """The reference's flags, from the same dataclasses.fields loop, plus
    --device."""
    import argparse

    p = argparse.ArgumentParser(description="HALVA DPA training (H100)")
    # argument types derived from annotations (Optional[float] etc.)
    kinds = {
        "epochs": float, "learning_rate": float, "loss_alpha": float,
        "lora_alpha": float, "warmup_ratio": float, "weight_decay": float,
        "mm_projector_lr": float,
        "per_device_batch": int, "grad_accum_steps": int, "lora_r": int,
        "max_length": int, "seed": int, "save_steps": int, "max_steps": int,
        "model_max_length": int,
        "log_every": int, "mesh_data": int, "mesh_model": int,
        "pack_rows": int, "pack_ref_rows": int, "pack_seq_len": int,
    }
    for f in dataclasses.fields(RunConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            p.add_argument(name, type=lambda x: x.lower() == "true",
                           default=f.default)
        elif f.name in kinds:
            p.add_argument(name, type=kinds[f.name], default=f.default)
        else:
            p.add_argument(name, default=f.default)
    return RunConfig(**vars(p.parse_args(argv)))


def main(argv=None):
    rcfg = parse_args(argv)
    mesh_axes(rcfg)  # a mesh that does not fit the world: before loading

    from transformers import AutoTokenizer

    tok_path = os.environ.get("HALVA_TOKENIZER", "lmsys/vicuna-7b-v1.5")
    try:
        # the reference loads the slow tokenizer (train_halva.py:1103)
        tok = AutoTokenizer.from_pretrained(tok_path, use_fast=False)
    except (ImportError, ValueError, OSError):
        # slow Llama tokenizers need sentencepiece; fall back to the fast
        # tokenizer (identical ids for Llama vocabularies)
        tok = AutoTokenizer.from_pretrained(tok_path, use_fast=True)
    tok.pad_token = tok.unk_token or tok.eos_token
    train(rcfg, tok)


if __name__ == "__main__":
    main()
