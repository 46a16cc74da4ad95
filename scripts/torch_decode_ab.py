#!/usr/bin/env python3
"""Times K4 (halva_tpu_torch decode_attend_layer) of the port found in TREE.

    python3 scripts/torch_decode_ab.py TREE [TREE ...]

For each TREE (a checkout of this repository, e.g. an older commit unpacked
with `git archive`) it imports `halva_tpu_torch` from there in a fresh
process, builds its kernels, and prints one JSON line of K4's device ms
(median of 20 CUDA-graph replays, each replay walking `layers` distinct
caches so every call reads from device memory) at the llava-1.5-7b decode
shapes that chip_smoke.py checks: B=4 rows of 623/615/608/623 prompt
tokens, Sg=128 gen slots valid to steps 0/37/100/127, H=KVH=32, D=128, in
the bf16, int8/int8 and int4/int8 modes; the beam mode (4 beams an item,
beam_route="grid"); and int4/int8 at batch 80. Then the device ms of one
whole greedy decode step of llava-v1.5-7b (random weights from the seed, 32
layers, B=4, gen slot 8, random prompt caches of those lengths): on the
bf16 tree with a bf16 cache, and on the int4g tree (quantized on the card,
groups of 128) with an int4 prompt cache. Inputs come from one seeded CUDA
generator, the same for every tree. Name the same trees in turns (old new
new old) to compare two builds on one card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

PROMPT_LENS = (623, 615, 608, 623)


def _time(fn, iters=20):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _caches(gen, mode, layers, items, rows, kvh, sp, sg, d):
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def sc(*shape, lo=0.01, hi=0.04):
        return (torch.rand(*shape, generator=gen, device="cuda") * (hi - lo)
                + lo).bfloat16()

    if mode == "bf16":
        return ({"k": r(layers, items, kvh, sp, d),
                 "v": r(layers, items, kvh, sp, d)},
                {"k": r(layers, rows, kvh, sg, d),
                 "v": r(layers, rows, kvh, sg, d)})
    if mode == "kv4":
        s2 = -(-sp // 2)
        pc = {"k4": i8(layers, items, kvh, s2, d),
              "v4": i8(layers, items, kvh, s2, d),
              "k_scale": sc(layers, items, 2, kvh, s2, lo=0.1, hi=0.3),
              "v_scale": sc(layers, items, 2, kvh, s2, lo=0.1, hi=0.3)}
    else:
        pc = {"k": i8(layers, items, kvh, sp, d),
              "v": i8(layers, items, kvh, sp, d),
              "k_scale": sc(layers, items, kvh, sp),
              "v_scale": sc(layers, items, kvh, sp)}
    gc = {"k": i8(layers, rows, kvh, sg, d), "v": i8(layers, rows, kvh, sg, d),
          "k_scale": sc(layers, rows, kvh, sg),
          "v_scale": sc(layers, rows, kvh, sg)}
    return pc, gc


def measure() -> dict:
    import torch
    from halva_tpu_torch.ops.decode_attention import decode_attend_layer

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, d, sp, sg = 32, 128, 623, 128
    out = {}
    cases = [(m, 4, 1, 8) for m in ("bf16", "kv8", "kv4")]
    cases += [(m, 4, 4, 4) for m in ("bf16", "kv8", "kv4")]
    cases += [("kv4", 80, 1, 2)]
    for mode, items, beam_k, layers in cases:
        rows = items * beam_k
        seg = (torch.arange(sp, device="cuda")[None, :] < torch.tensor(
            PROMPT_LENS * (items // 4), device="cuda")[:, None]).to(
                torch.int32)
        if beam_k == 1 and items == 4:
            steps = torch.tensor([0, 37, 100, 127], device="cuda")
        else:
            steps = torch.randint(0, sg, (rows,), generator=gen, device="cuda")
        gv = torch.arange(sg, device="cuda")[None, :] <= steps[:, None]
        q = torch.randn(rows, 1, h, d, generator=gen, device="cuda").bfloat16()
        pc, gc = _caches(gen, mode, layers, items, rows, h, sp, sg, d)

        def walk():
            for li in range(layers):
                decode_attend_layer(
                    q, {k: v[li] for k, v in pc.items()}, seg,
                    {k: v[li] for k, v in gc.items()}, gv, beam_k=beam_k,
                    beam_route="grid")

        key = f"{mode} B={items}" + (f" K={beam_k}" if beam_k > 1 else "")
        out[key] = _time(walk) / layers
        del pc, gc
        torch.cuda.empty_cache()
    out.update(step_times(gen))
    return out


def step_times(gen) -> dict:
    import torch
    from halva_tpu_torch import tree
    from halva_tpu_torch.config import LLAVA_V15_7B
    from halva_tpu_torch.models import llama
    from halva_tpu_torch.ops.generate import init_gen_cache_like
    from halva_tpu_torch.ops.w4_matmul import quantize_params_int4

    cfg, b, sp, at = LLAVA_V15_7B, 4, 623, 8
    c = cfg.llm
    params = tree.init_params(cfg, gen, torch.bfloat16)
    lens = torch.tensor(PROMPT_LENS, device="cuda")
    seg = (torch.arange(sp, device="cuda")[None, :] < lens[:, None]).to(
        torch.int32)
    token = torch.randint(0, c.vocab_size, (b, 1), generator=gen,
                          device="cuda")
    out = {}
    for name, mode in (("bf16 step", "bf16"), ("int4g step", "kv4")):
        if mode == "kv4":
            with torch.no_grad():
                q4 = quantize_params_int4(params, group_size=128)
            del params
            params = q4
        pc, _ = _caches(gen, mode, c.num_layers, b, b, c.kv_heads, sp, 2,
                        c.head_size)
        gen_cache = init_gen_cache_like(c, b, 32, pc)
        emb = llama.embed(params["llm"], token)
        with torch.inference_mode():
            out[name] = _time(lambda: llama.decode_step(
                params["llm"], c, emb, lens + at, pc, seg, gen_cache, at))
        del pc, gen_cache
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        print(json.dumps(measure()))
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    for tree in sys.argv[1:]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", os.path.abspath(tree)],
                             capture_output=True,
                             text=True, cwd=os.path.abspath(tree))
        if res.returncode:
            raise SystemExit(f"{tree}: exit {res.returncode}\n{res.stderr}")
        print(json.dumps({"tree": tree,
                          "k4_ms": json.loads(res.stdout.splitlines()[-1])}))


if __name__ == "__main__":
    main()
