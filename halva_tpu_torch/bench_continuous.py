"""Continuous batching against the bucketed drain, on one card.

Counterpart of scripts/bench_continuous.py, with its workload and JSON
keys. N requests whose token budgets follow a CHAIR-like caption-length
distribution (`chair_like_budgets`: lognormal around 95, sigma 0.35,
clipped to [24, cap], seed 3). Budgets stand in for EOS exits: random
weights emit no real EOS, and a row that reaches its budget frees its slot
as an EOS row would.

- drain: the one-shot loop's semantics on this workload: each batch of B
  rows decodes until its longest row is done. Timed as full-budget batches
  (`generate_greedy` with no EOS exit; the max of B >= 40 draws is ~cap).
- continuous: ops/continuous.ContinuousEngine (chunked decode from one
  CUDA graph, slots refilled as rows finish), the same budgets, timed end
  to end with its refill prefills and host reads, after a warm-up run of
  one batch of requests on the same engine.

The serving tree is the bench's (halva_tpu_torch/bench.py: random int4g
weights from a seed, int4 prompt KV); no host library beyond numpy.

    python -m halva_tpu_torch.bench_continuous [--batch 80] \\
        [--requests 240] [--cap 128] [--chunk 16] [--weights int4g]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from halva_tpu_torch import bench
from halva_tpu_torch.constants import IMAGE_TOKEN_INDEX

PROMPT_LEN = 48  # text tokens; the splice adds 575

_T0 = time.time()


def _prog(msg):
    print(f"[cb +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def chair_like_budgets(n: int, cap: int, seed: int = 3) -> np.ndarray:
    rng = np.random.RandomState(seed)
    b = np.exp(rng.normal(np.log(95.0), 0.35, n))
    return np.clip(b.round().astype(np.int32), 24, cap)


def workload(cfg, n: int):
    """(ids (n, PROMPT_LEN) int32 with the image sentinel at 1, images
    (n, 3, H, W) fp32), from seed 0 as the reference's."""
    rng = np.random.RandomState(0)
    ids = rng.randint(5, 30000, (n, PROMPT_LEN)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    images = rng.randn(n, 3, cfg.vision.image_size,
                       cfg.vision.image_size).astype(np.float32)
    return ids, images


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_continuous(params, cfg, ids, images, budgets, batch, cap, chunk,
                   kv_quant, device, on_timed=None):
    """(engine, results, wall seconds) of the timed continuous run;
    `on_timed`, when given, is called just before its clock starts."""
    from halva_tpu_torch.ops.continuous import ContinuousEngine, Request

    eng = ContinuousEngine(params, cfg, batch=batch, max_new_tokens=cap,
                           eos_id=-1, prompt_pad=PROMPT_LEN, chunk=chunk,
                           kv_quant=kv_quant, attn_impl="auto")
    reqs = [Request(ids=ids[i], image=images[i], budget=int(budgets[i]))
            for i in range(len(budgets))]
    _prog("continuous: warm-up (the kernel build, the graph capture)")
    warm = eng.run(reqs[:batch])
    if any(r is None for r in warm):
        raise RuntimeError("continuous warm-up: a request got no result")
    eng.stats = {"chunks": 0, "refills": 0, "steps": 0}
    _prog("continuous: timed run")
    _sync(device)
    if on_timed is not None:
        on_timed()
    t0 = time.perf_counter()
    out = eng.run(reqs)  # ends in host reads of the tokens: fenced
    return eng, out, time.perf_counter() - t0


def run_drain(params, cfg, ids, images, batch, cap, kv_quant, device):
    """(wall seconds, batches) of full-budget greedy batches."""
    from halva_tpu_torch.ops.generate import generate_greedy

    nb = len(ids) // batch
    lens = torch.full((batch,), PROMPT_LEN, dtype=torch.int32, device=device)

    def one(k):
        s = k * batch
        toks, _ = generate_greedy(
            params, cfg, torch.from_numpy(ids[s:s + batch]).to(device),
            torch.from_numpy(images[s:s + batch]).to(device), lens, cap,
            eos_id=-1, kv_quant=kv_quant)
        toks.cpu()  # host read: the fence

    _prog("drain: warm-up")
    one(0)
    _prog("drain: timed run")
    _sync(device)
    t0 = time.perf_counter()
    for k in range(nb):
        one(k)
    return time.perf_counter() - t0, nb


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=80)
    ap.add_argument("--requests", type=int, default=240)
    ap.add_argument("--cap", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--weights", default=os.environ.get(
        "HALVA_BENCH_WEIGHTS", "int4g"))
    args = ap.parse_args(argv)
    os.environ.setdefault("HALVA_W4A8", "1")
    cfg = bench.pick_cfg()  # HALVA_BENCH_PRESET (llava-v1.5-7b default)
    kv_mode = os.environ.get("HALVA_BENCH_KV", "int4")
    kv_quant = kv_mode if kv_mode in ("int8", "int4") else False
    _prog(f"building the {args.weights} tree on {device}")
    params = bench.synth_params(cfg, args.weights, device=device)
    budgets = chair_like_budgets(args.requests, args.cap)
    ids, images = workload(cfg, args.requests)
    with torch.inference_mode():
        eng, out, cont_wall = run_continuous(
            params, cfg, ids, images, budgets, args.batch, args.cap,
            args.chunk, kv_quant, device)
        emitted = int(sum(n for _, n in out))
        if [n for _, n in out] != budgets.tolist():
            raise RuntimeError("continuous: a request emitted other than "
                               "its budget")
        steps = eng.stats["steps"]
        cont = {
            "wall_s": round(cont_wall, 3),
            "imgs_per_sec": round(args.requests / cont_wall, 3),
            "tokens_per_sec": round(emitted / cont_wall, 1),
            "lockstep_steps": steps,
            "chunks": eng.stats["chunks"],
            "refills": eng.stats["refills"],
            "occupancy": round(emitted / max(1, steps * args.batch), 4),
        }
        _prog(f"continuous: {cont}")
        del eng
        drain_wall, nb = run_drain(params, cfg, ids, images, args.batch,
                                   args.cap, kv_quant, device)
    drain = {
        "wall_s": round(drain_wall, 3),
        "imgs_per_sec": round(nb * args.batch / drain_wall, 3),
        "steps": nb * args.cap,
        "step_time_s": round(drain_wall / nb, 3),  # one batch of B
    }
    _prog(f"drain: {drain}")
    backend = torch.device(device).type
    if backend == "cuda":
        backend += f" ({torch.cuda.get_device_name(device)})"
    result = {
        "metric": "continuous_vs_drain",
        "batch": args.batch,
        "requests": args.requests,
        "cap_tokens": args.cap,
        "chunk": args.chunk,
        "weights": args.weights,
        "kv": kv_mode,
        "budget_mean": round(float(budgets.mean()), 1),
        "budget_p10_p90": [int(np.percentile(budgets, 10)),
                           int(np.percentile(budgets, 90))],
        "continuous": cont,
        "drain": drain,
        "speedup": round(cont["imgs_per_sec"] / drain["imgs_per_sec"], 3),
        "backend": backend,
        "note": ("budgets stand in for EOS exits (random weights emit no "
                 "real EOS); drain pays max-of-batch (~cap) per batch, "
                 "continuous pays mean + chunk quantization + refill "
                 "overhead; both walls include prefill and host reads"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
