#!/usr/bin/env python3
"""Smoke run of the PyTorch port (halva_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version at the shapes the llava-1.5-7b decode path gives it,
then drives the port's main path at full width: LLaVA-1.5-7B (CLIP
ViT-L/14-336, mlp2x_gelu projector, 32-layer Llama-7B) with random bf16
weights from a seed, greedy decode of 4 requests. Every phase prints one
line; any failure raises and exits non-zero. The last line is the device
record {"ok": true, "device": {...}}.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from halva_tpu_torch import _kernels, tree
from halva_tpu_torch.config import LLAVA_V15_7B
from halva_tpu_torch.models import llama
from halva_tpu_torch.models.llava import LlavaModel
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
)
from halva_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_plain,
)
from halva_tpu_torch.ops.generate import (
    _prefill_impl,
    generate_greedy,
    init_gen_cache_like,
)

# bf16 kernel vs plain version on the same bf16 inputs, elementwise
# |got - plain| <= KERNEL_ATOL + KERNEL_RTOL * |plain|, and the relative
# norm of the difference <= KERNEL_RTOL. Both round the output to bf16 (one
# step is 2^-8..2^-7 relative); the kernels also round P to bf16 for the
# tensor-core PV product, as the Pallas kernels do.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
LSE_MAX_ABS = 1e-3  # fp32 statistic: only the summation order differs
# first-token logits of the kernel path vs the plain path, 32 bf16 layers:
# the attention outputs differ by the P rounding above, and the difference
# travels through every later layer's bf16 activations
LOGITS_REL = 2e-2

PROMPT_LENS = (623, 615, 608, 623)  # spliced lengths of the 48/40/33/48 prompts
TEXT_LENS = (48, 40, 33, 48)  # the requests' text tokens, image sentinel at 1
NEW_TOKENS = 32
COMPARE_STEPS = 4  # decode steps re-run on the plain path


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def within(got: torch.Tensor, want: torch.Tensor) -> bool:
    diff = (got.float() - want.float()).abs()
    return bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()
                and rel_err(got, want) <= KERNEL_RTOL)


def lengths_to_seg(lens, s, dev) -> torch.Tensor:
    pos = torch.arange(s, device=dev)[None, :]
    return (pos < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)


def phase_build() -> None:
    t0 = time.perf_counter()
    _kernels.lib()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _kernels.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {secs:.1f} s for {', '.join(_kernels.SOURCES)}")
    for ln in ptxas:
        print(f"  ptxas: {ln}")


def check_flash(gen: torch.Generator) -> dict:
    """K1 against flash_attention_plain at the 7B prefill shape."""
    dev = "cuda"
    b, s, h, d = 4, 623, 32, 128
    worst = 0.0
    for kvh, causal, seg_kind in ((32, True, "pad"), (8, True, "pad"),
                                  (32, False, "packed")):
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        seg = lengths_to_seg(PROMPT_LENS, s, dev)
        if seg_kind == "packed":  # two documents in every row
            seg = seg * (1 + (torch.arange(s, device=dev) >= 300).int())
        o, lse = flash_attention_fwd(q, k, v, seg, seg, causal=causal)
        want = flash_attention_plain(q, k, v, seg, seg, causal=causal)
        torch.cuda.synchronize()
        live = seg != 0
        err = max_abs(o[live], want[live])
        rel = rel_err(o[live], want[live])
        # the plain log-sum-exp of the same masked logits
        kr = k.repeat_interleave(h // kvh, dim=2).float()
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * d**-0.5
        mask = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        if causal:
            mask &= torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        want_lse = logits.masked_fill(~mask[:, None], -1e30).logsumexp(-1)
        live_h = live[:, None, :].expand(b, h, s)
        lse_err = max_abs(lse[live_h], want_lse[live_h])
        ok = (within(o[live], want[live]) and lse_err <= LSE_MAX_ABS
              and bool(torch.isfinite(o).all()))
        print(f"flash_fwd B={b} S={s} H={h} KVH={kvh} D={d} causal={causal} "
              f"{seg_kind}: max_abs_err {err:.3e} rel {rel:.3e} "
              f"lse_err {lse_err:.3e} (limits {KERNEL_ATOL} + {KERNEL_RTOL}"
              f"*|plain|, rel {KERNEL_RTOL}, lse {LSE_MAX_ABS}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_fwd disagrees with its plain version")
        worst = max(worst, err)
        if kvh == h and causal:
            args = (q, k, v, seg, seg)
            ms = timed_ms(lambda: flash_attention_fwd(*args, causal=True))
            plain_ms = timed_ms(
                lambda: flash_attention_plain(*args, causal=True))
            # QK^T and PV, 2 * D FLOP each per live (query, key) pair
            flops = 4 * h * d * sum(n * (n + 1) / 2 for n in PROMPT_LENS)
            print(f"flash_fwd time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms; {flops / ms / 1e9:.1f} TFLOP/s on live causal pairs")
            timing = (ms, plain_ms)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "halva_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "halva_tpu/ops/flash_attention.py:83",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def check_decode(gen: torch.Generator) -> dict:
    """K4 against decode_attend_plain at the 7B decode shape."""
    dev = "cuda"
    b, h, sp, sg, d, layers = 4, 32, 623, 128, 128, 8
    steps = torch.tensor([0, 37, 100, 127], device=dev)
    gen_valid = torch.arange(sg, device=dev)[None, :] <= steps[:, None]
    seg = lengths_to_seg(PROMPT_LENS, sp, dev)
    worst = 0.0
    for kvh in (32, 8):
        q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
        # `layers` distinct caches: the timing loop walks them, so each call
        # reads its cache from device memory, not from the 50 MB L2
        kp = torch.randn(layers, b, kvh, sp, d, generator=gen,
                         device=dev).bfloat16()
        vp = torch.randn(kp.shape, generator=gen, device=dev).bfloat16()
        kg = torch.randn(layers, b, kvh, sg, d, generator=gen,
                         device=dev).bfloat16()
        vg = torch.randn(kg.shape, generator=gen, device=dev).bfloat16()

        def call(fn, li):
            return fn(q, {"k": kp[li], "v": vp[li]}, seg,
                      {"k": kg[li], "v": vg[li]}, gen_valid)

        err = rel = 0.0
        ok = True
        for li in (0, layers - 1):
            got = call(decode_attend_layer, li)
            want = call(decode_attend_plain, li)
            torch.cuda.synchronize()
            err = max(err, max_abs(got, want))
            rel = max(rel, rel_err(got, want))
            ok = ok and within(got, want) and bool(torch.isfinite(got).all())
        print(f"decode_attn B={b} H={h} KVH={kvh} Sp={sp} Sg={sg} D={d}: "
              f"max_abs_err {err:.3e} rel {rel:.3e} (limits {KERNEL_ATOL} + "
              f"{KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("decode_attn disagrees with its plain version")
        worst = max(worst, err)
        if kvh != h:
            continue

        def walk(fn):
            for li in range(layers):
                call(fn, li)

        ms = timed_ms(lambda: walk(decode_attend_layer)) / layers
        plain_ms = timed_ms(lambda: walk(decode_attend_plain)) / layers
        row = kvh * d * 2 * 2  # k + v bytes of one cache position, all heads
        nominal = b * (sp + sg) * row
        read = (sum(PROMPT_LENS) + int((steps + 1).sum())) * row
        print(f"decode_attn time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms;"
              f" cache bytes {nominal / 1e6:.1f} MB allocated, "
              f"{read / 1e6:.1f} MB live -> {read / ms / 1e6:.0f} GB/s live")
        timing = (ms, plain_ms)
    return {"name": "decode_attn", "route": "cuda",
            "source": "halva_tpu_torch/csrc/decode_attn.cu",
            "replaces": "halva_tpu/ops/decode_attention.py:82",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def make_inputs(cfg):
    """4 requests shaped like bench.make_inputs: 48 token slots, the image
    sentinel at index 1, prompt lengths 48/40/33/48, random pixels."""
    rng = np.random.RandomState(0)
    b, s = len(TEXT_LENS), max(TEXT_LENS)
    ids = rng.randint(5, 30000, (b, s)).astype(np.int32)
    ids[:, 1] = -200  # IMAGE_TOKEN_INDEX
    for r, n in enumerate(TEXT_LENS):
        ids[r, n:] = 0
    size = cfg.vision.image_size
    images = rng.randn(b, 3, size, size).astype(np.float32)
    lens = np.asarray(TEXT_LENS, np.int32)
    return tuple(torch.from_numpy(x).cuda() for x in (ids, images, lens))


def run_model(kernels: list) -> None:
    """The port's main path at full width, then the plain path beside it."""
    cfg = LLAVA_V15_7B
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlavaModel(cfg, tree.init_params(cfg, gen, torch.bfloat16, "cuda"))
    params = model.params
    n_params = sum(t.numel() for _, t in tree.flatten(params))
    torch.cuda.synchronize()
    print(f"model: llava-v1.5-7b, {cfg.llm.num_layers} layers, hidden "
          f"{cfg.llm.hidden_size}, CLIP ViT-L/14-{cfg.vision.image_size}; "
          f"{n_params / 1e9:.3f} B random bf16 params from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]

    with torch.inference_mode():
        # warm-up (cuBLAS handles, allocator), not counted
        generate_greedy(params, cfg, *inputs, max_new_tokens=2, eos_id=-1)
        torch.cuda.synchronize()

        # timed prefill alone: the breakdown of the main run below
        t0 = time.perf_counter()
        _prefill_impl(params, cfg, *inputs)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0

        # the main path: eos_id -1 is never emitted, so every row decodes
        # NEW_TOKENS steps; counts start at 0 right before it
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        tokens, num = generate_greedy(params, cfg, *inputs,
                                      max_new_tokens=NEW_TOKENS, eos_id=-1)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        peak = torch.cuda.max_memory_allocated()

    layers = cfg.llm.num_layers
    want = {"flash_fwd": layers, "decode_attn": layers * NEW_TOKENS}
    ok = launches == want
    print(f"launches in the main run: {launches} (expected {want}: one per "
          f"layer per prefill, one per layer per decode step) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the main path did not run every kernel")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    tok_ok = bool(((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()
                  and (num == NEW_TOKENS).all())
    print(f"tokens: shape {tuple(tokens.shape)}, all in [0, "
          f"{cfg.llm.vocab_size}), {NEW_TOKENS} per row "
          f"{'ok' if tok_ok else 'FAIL'}")
    if not tok_ok:
        raise AssertionError("generated tokens out of range")
    decode_s = total_s - prefill_s
    print(f"main path: prefill {prefill_s * 1e3:.2f} ms (B={b}, "
          f"{max(PROMPT_LENS)} spliced tokens), decode "
          f"{decode_s / NEW_TOKENS * 1e3:.3f} ms/step, "
          f"{b * NEW_TOKENS / decode_s:.1f} decode tokens/s, "
          f"{b * NEW_TOKENS / total_s:.1f} tokens/s end to end "
          f"({total_s:.3f} s), peak memory {peak / 2**30:.2f} GiB")

    # the plain path beside the kernel path: prefill and the first decode
    # steps, both fed the main run's greedy tokens
    with torch.inference_mode():
        runs = {}
        for impl in ("auto", "plain"):
            first_tok, first_logits, slen, pc, pseg = _prefill_impl(
                params, cfg, *inputs, attn_impl=impl)
            gen_cache = init_gen_cache_like(cfg.llm, b, NEW_TOKENS, pc)
            logits = [first_logits]
            for step in range(COMPARE_STEPS):
                emb = llama.embed(params["llm"], tokens[:, step, None])
                lg, gen_cache = llama.decode_step(
                    params["llm"], cfg.llm, emb, slen + step, pc, pseg,
                    gen_cache, step, attn_impl=impl)
                logits.append(lg)
            runs[impl] = torch.stack(logits)  # (1 + steps, B, V)
            del pc, gen_cache
    finite = bool(torch.isfinite(runs["auto"]).all()
                  and torch.isfinite(runs["plain"]).all())
    first_rel = rel_err(runs["auto"][0], runs["plain"][0])
    step_rel = [rel_err(runs["auto"][i], runs["plain"][i])
                for i in range(1, COMPARE_STEPS + 1)]
    agree = float((runs["auto"].argmax(-1) == runs["plain"].argmax(-1))
                  .float().mean())
    ok = finite and first_rel <= LOGITS_REL
    print(f"kernel vs plain path: first-token logits rel err {first_rel:.3e} "
          f"(limit {LOGITS_REL}), decode steps 1-{COMPARE_STEPS} rel err "
          + ", ".join(f"{e:.3e}" for e in step_rel)
          + f"; greedy agreement {agree:.3f} over {runs['auto'].shape[0]} "
          f"positions x {b} rows; logits finite {finite} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel path disagrees with the plain path")


def check_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [check_flash(gen), check_decode(gen)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    # fp32 matmuls and convolutions in full fp32 (cuDNN convolutions default
    # to TF32, ~3 decimal digits), so every plain reference is exact fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_line())
    phase_build()
    kernels = check_kernels()
    run_model(kernels)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "halva_tpu")
    if "jax" in sys.modules or set(loaded) - {
            "halva_tpu", "halva_tpu.config", "halva_tpu.constants"}:
        raise AssertionError(f"JAX code was imported: {loaded}")
    print(f"imports: no jax; from halva_tpu only the framework-free {loaded}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
