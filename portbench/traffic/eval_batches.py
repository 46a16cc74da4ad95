"""Traffic kind `eval_batches`: the eval suite's batched greedy decode.

The window drives the call `evals/runner.BatchedGenerator.run` makes for
each batch, `ops/generate.generate_greedy` under inference mode, one batch
after another (one caller, a closed loop): copy the batch in, generate,
tokens to the host, the next batch.

Each batch (cell parameters under "traffic") holds `rows` requests, each
one image and a prompt of `prompt_tokens` text tokens (BOS first, the image
sentinel at `image_at`), right-padded to a multiple of `prompt_bucket` as
the runner pads. A request's answer length is `new_tokens`: "fixed", or a
lognormal ("median", "sigma", clipped to "min".."max"); the batch decodes
its longest row's length with no EOS (random weights emit none), and the
shorter rows are stepped with it, as the lockstep loop steps rows that are
done. Sizes come from `design_seed`, the same in every run; token ids and
pixels from the run's seed. The pool of `batches` batches cycles.

After the window a sample of the finished requests, drawn from the seed
and holding the longest, with at least `check_tokens` served tokens, goes
to the plain reference: one forward pass over each prompt with its served
tokens. For each served token, its gap is the distance by which its
logit lies below the reference's largest logit at its position; the
number compared is `mean_gap`, the mean over the sampled tokens (the
widest gap, `gap`, and the share of tokens that are not the reference's
first, `flips`, are kept as readings).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, harness, trace as trace_lib
from portbench.traffic.dpa_train import _prompt, pixels


def quantile_lengths(n: int, median: float, sigma: float, lo: int, hi,
                     rng: np.random.Generator) -> np.ndarray:
    """n lognormal lengths at the n midpoint quantiles, in an order from
    `rng`, clipped to [lo, hi] (hi may be an array)."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.round(median * np.exp(sigma * z)).astype(np.int64)
    return np.clip(rng.permutation(lens), lo, hi)


def design(p: dict) -> List[dict]:
    """Per batch: each row's prompt length and answer length."""
    rng = np.random.default_rng(p["design_seed"])
    n = p["batches"] * p["rows"]
    prompt = rng.integers(p["prompt_tokens"][0], p["prompt_tokens"][1] + 1, n)
    nt = p["new_tokens"]
    if "fixed" in nt:
        served = np.full(n, nt["fixed"], np.int64)
    else:
        served = quantile_lengths(n, nt["median"], nt["sigma"], nt["min"],
                                  nt["max"], rng)
    r = p["rows"]
    return [{"prompt": [int(x) for x in prompt[i:i + r]],
             "served": [int(x) for x in served[i:i + r]]}
            for i in range(0, n, r)]


def make_batches(p: dict, model: dict, seed: int) -> List[dict]:
    vocab = model["llm"]["vocab_size"]
    size = model["vision"]["image_size"]
    rng = np.random.default_rng(seed)
    out = []
    for d in design(p):
        rows = len(d["prompt"])
        width = -(-max(d["prompt"]) // p["prompt_bucket"]) * p["prompt_bucket"]
        ids = np.zeros((rows, width), np.int32)
        for j, n in enumerate(d["prompt"]):
            ids[j, :n] = _prompt(rng, n, p["image_at"], vocab)
        out.append({
            "ids": torch.from_numpy(ids),
            "images": torch.from_numpy(pixels(rng, rows, size)),
            "lens": torch.tensor(d["prompt"], dtype=torch.int32),
            "served": d["served"],
            "max_new": max(d["served"]),
        })
    return out


def spliced(batch: dict, image_tokens: int) -> List[int]:
    return [int(n) + image_tokens - 1 for n in batch["lens"]]


def shapes(batch: dict, steps: int, image_tokens: int,
           decode_kernel: bool) -> Dict[str, object]:
    """What a batch's work follows: the live spliced prompt lengths, their
    padded width, the decode loop's steps, and whether its decode path
    takes the decode-attention kernel (K4)."""
    return {"prefill": spliced(batch, image_tokens),
            "s_pad": int(batch["ids"].shape[1]) + image_tokens - 1,
            "steps": int(steps), "decode_kernel": bool(decode_kernel)}


def generate(params, cfg, batch: dict, device, stats: dict):
    from halva_tpu_torch.ops.generate import generate_greedy

    ids = batch["ids"].to(device)
    images = batch["images"].to(device)
    lens = batch["lens"].to(device)
    with torch.inference_mode():
        tokens, _ = generate_greedy(params, cfg, ids, images, lens,
                                    max_new_tokens=batch["max_new"],
                                    eos_id=-1, loop_stats=stats)
    return tokens.cpu().numpy()


def sample(units: List[dict], pool: List[dict], rng: np.random.Generator,
           min_tokens: int) -> List[tuple]:
    """(unit, row) pairs of finished requests, one unit for each pool
    batch the window finished (the pool cycles): the longest answer first,
    then others drawn from `rng` until `min_tokens` served tokens."""
    first: Dict[int, int] = {}
    for u, unit in enumerate(units):
        first.setdefault(unit["batch"], u)
    cands = [(u, r) for _, u in sorted(first.items())
             for r in range(len(pool[units[u]["batch"]]["served"]))]
    served = [pool[units[u]["batch"]]["served"][r] for u, r in cands]
    top = int(np.argmax(served))
    picked = [cands[top]]
    total = served[top]
    for i in rng.permutation(len(cands)):
        if total >= min_tokens:
            break
        if i != top:
            picked.append(cands[i])
            total += served[i]
    return picked


def gaps(ref, requests: List[tuple], device) -> Dict[str, float]:
    """requests: (valid prompt ids with the sentinel, image (3, H, W),
    served tokens). Over every served token, the gap between the
    reference's largest logit at its position and its own: the widest,
    the mean, and the share of tokens that are not the reference's
    first."""
    images = torch.stack([torch.as_tensor(im) for _, im, _ in requests])
    feats = ref.features(images.to(device))
    rows, where = [], []
    table = ref.w["llm"]["embed"]["embedding"]
    for i, (ids, _, served) in enumerate(requests):
        prompt = ref.embed_row(ids, feats[i])
        extra = torch.as_tensor(np.asarray(served[:-1], np.int64),
                                device=device)
        rows.append(torch.cat([prompt, table[extra].float()]))
        n = prompt.shape[0]
        where.append(torch.arange(n - 1, n - 1 + len(served), device=device))
    hs = ref.hidden(rows, lora=False)
    every = []
    with torch.no_grad():
        for h, pos, (_, _, served) in zip(hs, where, requests):
            logits = ref.logits(h[pos])
            tok = torch.as_tensor(np.asarray(served, np.int64),
                                  device=device)
            every.append(logits.max(-1).values
                         - logits.gather(-1, tok[:, None])[:, 0])
    every = torch.cat(every)
    return {"gap": float(every.max()), "mean_gap": float(every.mean()),
            "flips": float((every > 0).float().mean())}


def prepare(ctx, quantize: bool = False) -> dict:
    """Weights and the batch pool from the seed; the program serves the
    weights as made, or (`quantize`: the control) its own int8 tree of
    them, the eval CLI's `--quant int8`."""
    cfg, params = harness.make_tree(ctx)
    served = params
    if quantize:
        from halva_tpu_torch.ops.quant import quantize_params

        with torch.no_grad():
            served = quantize_params(params)
    return {"cfg": cfg, "params": params, "served": served,
            "pool": make_batches(ctx.params, ctx.model, ctx.seed)}


def unit(ctx, st: dict, i: int, start: float, decode_kernel: bool,
         tracer=None) -> dict:
    """Batch i of the loop: its wall time, tokens, loop stats and work."""
    image_tokens = harness.image_tokens(ctx.model)
    k = i % len(st["pool"])
    b = st["pool"][k]
    stats: dict = {}
    t0 = time.perf_counter()
    with (tracer.unit(i) if tracer else contextlib.nullcontext()):
        tokens = generate(st["served"], st["cfg"], b, ctx.device, stats)
    t1 = time.perf_counter()
    return {
        "t": t1 - t0, "end": t1 - start, "items": len(b["served"]),
        "batch": k, "tokens": tokens, "loop": stats,
        "traced": bool(tracer and tracer.traced(i)),
        "flops": flops.eval_batch_flops(ctx.model, spliced(b, image_tokens),
                                        b["served"]),
        "shapes": shapes(b, stats["steps"], image_tokens, decode_kernel),
    }


def check(ctx, st: dict, units: List[dict]) -> Dict[str, float]:
    """The reference over a sample of the finished requests, drawn from
    the seed; the numbers the cell's limits name."""
    from portbench.reference.llava import Reference

    pool = st["pool"]
    rng = np.random.default_rng(ctx.seed)
    picked = sample(units, pool, rng, ctx.params["check_tokens"])
    requests = []
    for u, r in picked:
        b = pool[units[u]["batch"]]
        n = int(b["lens"][r])
        requests.append((b["ids"][r, :n].numpy(), b["images"][r].numpy(),
                         units[u]["tokens"][r, :b["served"][r]]))
    ref = Reference(st["params"], ctx.config)
    found = gaps(ref, requests, ctx.device)
    ref.release()
    st["readings"] = {**found, "sampled_requests": len(requests),
                      "sampled_tokens": sum(len(x[2]) for x in requests)}
    return found


def warm_up(ctx, st: dict) -> bool:
    """One batch of each padded prompt width, the pool's longest decode at
    that width; whether the path launched the decode kernel (K4)."""
    from halva_tpu_torch import _kernels

    widths: Dict[int, dict] = {}
    for b in st["pool"]:
        w = b["ids"].shape[1]
        if w not in widths or b["max_new"] > widths[w]["max_new"]:
            widths[w] = b
    _kernels.reset_launches()
    for b in widths.values():
        generate(st["served"], st["cfg"], b, ctx.device, {})
    harness.sync(ctx.device)
    return any(k.startswith("decode_attn") for k in _kernels.launches)


def run(ctx) -> dict:
    p, dev = ctx.params, ctx.device
    st = prepare(ctx)
    decode_kernel = warm_up(ctx, st)
    tracer = trace_lib.Tracer(p["trace_first"], p["trace_units"]) \
        if ctx.trace else None
    units = []
    harness.window_opens()
    start = time.perf_counter()
    setup_s = start - ctx.t0
    i = 0
    while True:
        units.append(unit(ctx, st, i, start, decode_kernel, tracer))
        i += 1
        if units[-1]["end"] >= ctx.seconds and (tracer is None
                                                or i > tracer.last):
            break
    peak = harness.peak_bytes(dev)
    harness.window_closes()

    # the check, after the window
    harness.free(dev)
    nums = check(ctx, st, units)
    for u in units:
        del u["tokens"]
    return {
        "kind": "eval_batches", "model": ctx.model, "units": units,
        "window_s": units[-1]["end"], "setup_s": setup_s,
        "peak_bytes": peak, "trace": tracer.trace if tracer else None,
        "attempted": sum(u["items"] for u in units), "failed": 0,
        "checks": harness.checks(nums, ctx.cell["limits"]),
        "readings": st["readings"],
    }
