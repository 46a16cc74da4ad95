"""Evaluation CLI: generate -> score pipelines, on the card.

Counterpart of halva_tpu/evals/cli.py, which replaces the reference's
bash orchestration (src/evaluate_hall/{chair,mme,amber,amber_f1,mmhal,
hallusionbench,pope}.sh): one command loads the model once
(models/builder.py) and runs batched decode (evals/runner.py, the decode
loops replayed from CUDA graphs), then scores with the copies of the
reference's scorers. GPT-judge benchmarks (MMHal, HallusionBench) score
only when OPENAI_API_KEY is set, matching the reference's optional judge
plumbing. The tokenizer comes from `transformers` and the images are
decoded with Pillow, both on the host.

The reference's arguments are kept: sampling (--temperature, --top-p),
--continuous and the device mesh (--mesh-data N --mesh-model M) run as in
the reference. A mesh runs one process a GPU under
`torchrun --nproc-per-node N*M` (RANK / WORLD_SIZE from the environment,
a world of another size is refused before anything loads); --mesh-model
alone means data 1, and an int4 tree under a model axis > 1 is packed for
it (quant_tp, HALVA_TP_IMPL=shmap). Every rank decodes its rows and rank 0
writes the answers and scores. --device (default cuda: `cuda:LOCAL_RANK`
under a mesh) names the device; the CPU runs the kernels' plain versions
(and a mesh there runs on gloo).

Usage:
  python -m halva_tpu_torch.evals.cli chair --model-path ... \
      --model-base ... --image-folder .../val2014 --coco-path ... \
      --answers-file out.jsonl --quant int4g --kv-quant int4
  python -m halva_tpu_torch.evals.cli pope --question-file ... \
      --image-folder ... --annotation-dir ...
  python -m halva_tpu_torch.evals.cli amber --query-file ... \
      --image-folder ... --anno-dir ...
  python -m halva_tpu_torch.evals.cli mme --question-file ... \
      --image-folder ... --mme-data ...
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

MODEL_ID = "halva-tpu-torch"


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower-path", default=None)
    p.add_argument("--conv-mode", default="v1")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--quant", choices=["none", "int8", "int4", "int4g"],
                   default="none",
                   help="weight quantization at load; int4 = the "
                        "headline serving config (stacked-int4 layer "
                        "kernels + int8 embeds, pair with --kv-quant)")
    p.add_argument("--kv-quant", nargs="?", const="int8",
                   choices=["int8", "int4"], default=False,
                   help="quantized prompt+generated KV cache: bare flag "
                        "or 'int8' halves decode KV HBM traffic; 'int4' "
                        "(nibble-packed token pairs) halves it again")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    # the reference loaders' --num_beams (model_vqa_loader.py:106-111);
    # HF-semantics beam search (ops/beam.py)
    p.add_argument("--num-beams", type=int, default=1)
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--answers-file", required=True)
    # the reference's device mesh: one process a GPU under torchrun
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh axis (0 = no mesh)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis")
    p.add_argument("--prefetch-workers", type=int, default=4,
                   help="host image-preprocess threads overlapped with "
                        "device decode (0 = serial)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: EOS-freed rows refill "
                        "from the queue (ops/continuous.py), so the "
                        "longest caption no longer gates the batch. "
                        "Greedy only")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative greedy decode: prompt-lookup "
                        "drafts verified K tokens per model pass "
                        "(ops/speculative.py; token-exact vs greedy). "
                        "Greedy only")
    p.add_argument("--device", default="cuda",
                   help="the device that holds the model (cpu: the "
                        "kernels' plain versions)")


def mesh_axes(args):
    """(data, model) of the mesh the flags ask for, or None: --mesh-model
    alone means data 1 (the reference's rule)."""
    data, model = args.mesh_data, args.mesh_model or 1
    if model > 1 and not data:
        data = 1
    return (data, model) if data else None


def check_world(axes) -> None:
    """Refuse a mesh whose size is not the world's, before anything
    loads."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if axes is not None and axes[0] * axes[1] != world:
        raise ValueError(
            f"{axes[0]}x{axes[1]} != {world} devices: run the mesh under "
            f"torchrun --nproc-per-node {axes[0] * axes[1]}")


def _device(args, axes) -> str:
    """--device; under a mesh on the card, this rank's card."""
    if axes is not None and args.device == "cuda":
        return f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return args.device


def is_writer(gen) -> bool:
    """Whether this process writes the answers and scores: rank 0 of a
    mesh, or the one process."""
    import torch.distributed as dist

    return gen.mesh is None or dist.get_rank() == 0


def _build_generator(args):
    from transformers import AutoTokenizer

    from halva_tpu_torch.evals.runner import BatchedGenerator
    from halva_tpu_torch.mm_utils import processor_for_vision
    from halva_tpu_torch.models.builder import load_pretrained_model
    from halva_tpu_torch.utils.phases import phase

    axes = mesh_axes(args)
    check_world(axes)
    device = _device(args, axes)
    mesh = None
    if axes is not None:
        from halva_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data=axes[0], model=axes[1], device=device)
    quant_tp = 1
    if (args.quant in ("int4", "int4g") and axes is not None and axes[1] > 1
            and os.environ.get("HALVA_TP_IMPL", "shmap") == "shmap"):
        quant_tp = axes[1]
    tok_src = args.tokenizer or args.model_base or args.model_path
    with phase("tokenizer_load"):
        try:
            # the reference loads the slow tokenizer (builder.py
            # use_fast convention); fast produces identical ids for
            # Llama vocabs and is the only option for tokenizer dirs
            # without sentencepiece
            tokenizer = AutoTokenizer.from_pretrained(
                tok_src, use_fast=False
            )
        except Exception:
            tokenizer = AutoTokenizer.from_pretrained(tok_src)
    # tokenizer passes through the loader so mm_use_im_start_end
    # checkpoints get their token re-add + mean-init embedding resize
    # (reference llava/model/builder.py:89-96)
    with phase("model_load_total"):
        params, cfg = load_pretrained_model(
            args.model_path,
            args.model_base,
            vision_tower_path=args.vision_tower_path,
            quant=args.quant,
            tokenizer=tokenizer,
            quant_tp=quant_tp,
            device=device,
        )
    return BatchedGenerator(
        params,
        cfg,
        tokenizer,
        # sized from the loaded config: CLIP-336 for llava-1.5, SigLIP
        # square-resize for VILA towers
        processor_for_vision(cfg.vision),
        image_aspect_ratio=cfg.image_aspect_ratio,
        template_name=args.conv_mode,
        batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        num_beams=getattr(args, "num_beams", 1),
        length_penalty=getattr(args, "length_penalty", 1.0),
        mesh=mesh,
        prefetch_workers=getattr(args, "prefetch_workers", 0),
        kv_quant=getattr(args, "kv_quant", False),
        continuous=getattr(args, "continuous", False),
        spec_k=getattr(args, "spec", 0),
    )


def cmd_chair(args):
    from halva_tpu_torch.evals.runner import chair_requests, write_answers_jsonl

    reqs = chair_requests(
        args.image_folder, args.num_chunks, args.chunk_idx
    )
    gen = _build_generator(args)
    t0 = time.time()
    texts = gen.run(reqs)
    if not is_writer(gen):  # rank 0 of a mesh writes
        return
    dt = time.time() - t0
    print(f"generated {len(reqs)} captions in {dt:.1f}s "
          f"({len(reqs)/dt:.2f} imgs/sec)")
    for r, t in zip(reqs, texts):
        r.extra["caption"] = t
    write_answers_jsonl(args.answers_file, reqs, texts, MODEL_ID)

    if args.coco_path or args.chair_cache:
        from halva_tpu_torch.evals.chair import ChairEvaluator

        if args.chair_cache and os.path.exists(args.chair_cache):
            ev = ChairEvaluator.from_cache(args.chair_cache)
        else:
            ev = ChairEvaluator.from_coco(args.coco_path)
            if args.chair_cache:
                ev.save_cache(args.chair_cache)
        out = ev.compute(
            texts, [r.question_id for r in reqs]
        )
        print(json.dumps(out["overall_metrics"], indent=2))


def cmd_pope(args):
    from halva_tpu_torch.evals.pope import eval_pope_files
    from halva_tpu_torch.evals.runner import vqa_requests, write_answers_jsonl

    reqs = vqa_requests(
        args.question_file, args.image_folder,
        args.num_chunks, args.chunk_idx,
        additional_input_prompt=args.additional_input_prompt,
    )
    gen = _build_generator(args)
    texts = gen.run(reqs)
    if not is_writer(gen):  # rank 0 of a mesh writes
        return
    write_answers_jsonl(args.answers_file, reqs, texts, MODEL_ID)
    if args.annotation_dir:
        out = eval_pope_files(
            args.answers_file, args.question_file, args.annotation_dir
        )
        print(json.dumps(out, indent=2))


def cmd_amber(args):
    from halva_tpu_torch.evals.amber import AmberEvaluator
    from halva_tpu_torch.evals.runner import amber_requests, write_answers_jsonl

    reqs = amber_requests(args.query_file, args.image_folder)
    gen = _build_generator(args)
    texts = gen.run(reqs)
    if not is_writer(gen):  # rank 0 of a mesh writes
        return
    for r, t in zip(reqs, texts):
        r.extra["response"] = t
    write_answers_jsonl(args.answers_file, reqs, texts, MODEL_ID)
    if args.anno_dir:
        ev = AmberEvaluator.from_files(
            os.path.join(args.anno_dir, "data/annotations.json"),
            os.path.join(args.anno_dir, "data/relation.json"),
            os.path.join(args.anno_dir, "data/safe_words.txt"),
        )
        rows = [
            {"id": r.question_id, "response": t}
            for r, t in zip(reqs, texts)
        ]
        print(json.dumps(ev.evaluate(rows, args.eval_type), indent=2))


def cmd_mme(args):
    from halva_tpu_torch.evals.mme import score_mme
    from halva_tpu_torch.evals.runner import vqa_requests, write_answers_jsonl

    reqs = vqa_requests(
        args.question_file, args.image_folder,
        additional_input_prompt=args.additional_input_prompt,
    )
    gen = _build_generator(args)
    texts = gen.run(reqs)
    if not is_writer(gen):  # rank 0 of a mesh writes
        return
    write_answers_jsonl(args.answers_file, reqs, texts, MODEL_ID)
    if args.mme_data:
        answers = [json.loads(l) for l in open(args.answers_file)]
        print(json.dumps(score_mme(answers, args.mme_data), indent=2))


def cmd_mmhal(args):
    """MMHal-Bench: generate answers; judge+summarize when a key is set
    (reference mmhal.sh runs the judge 3x and averages)."""
    from halva_tpu_torch.evals import mmhal
    from halva_tpu_torch.evals.runner import mmhal_requests, write_answers_jsonl

    with open(args.data_file) as f:
        data = json.load(f)
    reqs = mmhal_requests(data, args.image_folder)
    gen = _build_generator(args)
    texts = gen.run(reqs)
    if not is_writer(gen):  # rank 0 of a mesh writes
        return
    write_answers_jsonl(args.answers_file, reqs, texts, MODEL_ID)

    if os.environ.get("OPENAI_API_KEY"):
        from halva_tpu_torch.evals.judge import openai_judge_fn

        judge = openai_judge_fn(model=args.judge_model)
        records = [
            {
                "image_content": r.extra["image_content"],
                "question": r.extra.get("prompt", r.text),
                "gt_answer": r.extra["gt_answer"],
                "model_answer": t,
            }
            for r, t in zip(reqs, texts)
        ]
        trials = [
            mmhal.judge_responses(records, judge)
            for _ in range(args.judge_trials)
        ]
        print(json.dumps(mmhal.summarize_trials(trials), indent=2))
    else:
        print("OPENAI_API_KEY not set — answers written, judging skipped")


def cmd_hallusionbench(args):
    from halva_tpu_torch.evals import hallusion
    from halva_tpu_torch.evals.runner import (
        hallusion_requests,
        write_answers_jsonl,
    )

    with open(args.data_file) as f:
        data = json.load(f)
    reqs = hallusion_requests(data, args.image_folder)
    gen = _build_generator(args)
    texts = gen.run(reqs)
    if not is_writer(gen):  # rank 0 of a mesh writes
        return
    write_answers_jsonl(args.answers_file, reqs, texts, MODEL_ID)

    rows = []
    for r, t in zip(reqs, texts):
        row = dict(r.extra)
        row["question"] = r.text
        row["model_prediction"] = t
        rows.append(row)
    if os.environ.get("OPENAI_API_KEY"):
        from halva_tpu_torch.evals.judge import openai_judge_fn

        rows = hallusion.judge_correctness(
            rows, openai_judge_fn(model=args.judge_model)
        )
    else:
        print("OPENAI_API_KEY not set — using exact-match correctness")
        rows = hallusion.exact_match_correctness(rows)
    print(json.dumps(hallusion.evaluate(rows), indent=2))


def cmd_suite(args):
    """Full hallucination suite with ONE model load (the reference's
    eval_hall_suite.sh reloads the model per benchmark; here the loaded
    params are shared and only prompts/images change). Under a mesh every
    rank decodes every set and rank 0 writes and scores."""
    gen = _build_generator(args)
    writer = is_writer(gen)
    out_dir = os.path.dirname(os.path.abspath(args.answers_file)) or "."
    results = {}

    from halva_tpu_torch.evals.runner import (
        chair_requests,
        vqa_requests,
        amber_requests,
        write_answers_jsonl,
    )

    if args.chair_image_folder:
        reqs = chair_requests(args.chair_image_folder)
        t0 = time.time()
        texts = gen.run(reqs)
        results["chair_imgs_per_sec"] = round(len(reqs) / (time.time() - t0), 3)
        if writer:
            write_answers_jsonl(
                os.path.join(out_dir, "chair.jsonl"), reqs, texts, MODEL_ID
            )
        if writer and args.coco_path:
            from halva_tpu_torch.evals.chair import ChairEvaluator

            ev = ChairEvaluator.from_coco(args.coco_path)
            results["chair"] = ev.compute(
                texts, [r.question_id for r in reqs]
            )["overall_metrics"]

    if args.pope_question_file:
        reqs = vqa_requests(args.pope_question_file, args.pope_image_folder)
        texts = gen.run(reqs)
        pope_path = os.path.join(out_dir, "pope.jsonl")
        if writer:
            write_answers_jsonl(pope_path, reqs, texts, MODEL_ID)
        if writer and args.pope_annotation_dir:
            from halva_tpu_torch.evals.pope import eval_pope_files

            results["pope"] = eval_pope_files(
                pope_path, args.pope_question_file, args.pope_annotation_dir
            )

    if args.amber_query_file:
        reqs = amber_requests(args.amber_query_file, args.amber_image_folder)
        texts = gen.run(reqs)
        if writer:
            write_answers_jsonl(
                os.path.join(out_dir, "amber.jsonl"), reqs, texts, MODEL_ID
            )
        if writer and args.amber_anno_dir:
            from halva_tpu_torch.evals.amber import AmberEvaluator

            ev = AmberEvaluator.from_files(
                os.path.join(args.amber_anno_dir, "data/annotations.json"),
                os.path.join(args.amber_anno_dir, "data/relation.json"),
                os.path.join(args.amber_anno_dir, "data/safe_words.txt"),
            )
            rows = [
                {"id": r.question_id, "response": t}
                for r, t in zip(reqs, texts)
            ]
            results["amber"] = ev.evaluate(rows, "a")

    if args.mme_question_file:
        reqs = vqa_requests(
            args.mme_question_file, args.mme_image_folder,
            additional_input_prompt=" Please answer yes or no.",
        )
        texts = gen.run(reqs)
        mme_path = os.path.join(out_dir, "mme.jsonl")
        if writer:
            write_answers_jsonl(mme_path, reqs, texts, MODEL_ID)
        if writer and args.mme_data:
            from halva_tpu_torch.evals.mme import score_mme

            answers = [json.loads(l) for l in open(mme_path)]
            results["mme"] = score_mme(answers, args.mme_data)

    if not writer:
        return
    with open(args.answers_file, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(json.dumps(results, indent=2, default=str))


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: one sub-command a benchmark, each with the
    reference's flags plus --device."""
    p = argparse.ArgumentParser(prog="halva_tpu_torch.evals")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("chair")
    _add_model_args(c)
    c.add_argument("--image-folder", required=True)
    c.add_argument("--coco-path", default=None)
    c.add_argument("--chair-cache", default=None)
    c.set_defaults(fn=cmd_chair)

    c = sub.add_parser("pope")
    _add_model_args(c)
    c.add_argument("--question-file", required=True)
    c.add_argument("--image-folder", required=True)
    c.add_argument("--annotation-dir", default=None)
    c.add_argument("--additional-input-prompt", default="")
    c.set_defaults(fn=cmd_pope)

    c = sub.add_parser("amber")
    _add_model_args(c)
    c.add_argument("--query-file", required=True)
    c.add_argument("--image-folder", required=True)
    c.add_argument("--anno-dir", default=None)
    c.add_argument("--eval-type", default="a")
    c.set_defaults(fn=cmd_amber)

    c = sub.add_parser("mme")
    _add_model_args(c)
    c.add_argument("--question-file", required=True)
    c.add_argument("--image-folder", required=True)
    c.add_argument("--mme-data", default=None)
    c.add_argument("--additional-input-prompt", default="")
    c.set_defaults(fn=cmd_mme)

    c = sub.add_parser("suite")
    _add_model_args(c)  # --answers-file = results summary json path
    c.add_argument("--chair-image-folder", default=None)
    c.add_argument("--coco-path", default=None)
    c.add_argument("--pope-question-file", default=None)
    c.add_argument("--pope-image-folder", default=None)
    c.add_argument("--pope-annotation-dir", default=None)
    c.add_argument("--amber-query-file", default=None)
    c.add_argument("--amber-image-folder", default=None)
    c.add_argument("--amber-anno-dir", default=None)
    c.add_argument("--mme-question-file", default=None)
    c.add_argument("--mme-image-folder", default=None)
    c.add_argument("--mme-data", default=None)
    c.set_defaults(fn=cmd_suite)

    c = sub.add_parser("mmhal")
    _add_model_args(c)
    c.add_argument("--data-file", required=True,
                   help="MMHal-Bench records json (96 questions)")
    c.add_argument("--image-folder", required=True)
    c.add_argument("--judge-model", default="gpt-4-0125-preview")
    c.add_argument("--judge-trials", type=int, default=3)
    c.set_defaults(fn=cmd_mmhal)

    c = sub.add_parser("hallusionbench")
    _add_model_args(c)
    c.add_argument("--data-file", required=True,
                   help="HallusionBench VD/VS json")
    c.add_argument("--image-folder", required=True)
    c.add_argument("--judge-model", default="gpt-4-0613")
    c.set_defaults(fn=cmd_hallusionbench)
    return p


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    finally:
        # startup-phase attribution (HALVA_PHASE_JSON, see utils/phases)
        from halva_tpu_torch.utils.phases import dump

        dump()
        import torch.distributed as dist

        if mesh_axes(args) is not None and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
