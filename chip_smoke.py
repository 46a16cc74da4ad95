#!/usr/bin/env python3
"""Smoke run of the PyTorch port (halva_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version at the shapes the llava-1.5-7b decode and train paths
give it,
then drives the port's main paths at full width: LLaVA-1.5-7B (CLIP
ViT-L/14-336, mlp2x_gelu projector, 32-layer Llama-7B) with random bf16
weights from a seed, greedy decode of 4 requests, first on the bf16 tree
(K1, K4 bf16); then the DPA LoRA train step on that tree (LoRA r=128 on
every LLM linear, remat, chunked loss, AdamW; K1 forward, K2 and K3
backward) for 4 micro-steps (2 updates), and one micro-step against the
plain path; then the int4g serving tree quantized on the card (int4 layer
stacks with g=128 scales, int8 projector/lm_head/embedding) with an int4
prompt KV cache (K1, K4 int4/int8, K6) and briefly an int8 one (K4
int8/int8). Every phase prints one line; any failure raises and exits
non-zero. The last line is the device record {"ok": true, "device": {...}}.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from halva_tpu_torch import _kernels, tree
from halva_tpu_torch.config import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    LLAVA_V15_7B,
)
from halva_tpu_torch.models import llama
from halva_tpu_torch.models.llava import LlavaModel
from halva_tpu_torch.ops.decode_attention import (
    decode_attend_layer,
    decode_attend_plain,
)
from halva_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_delta,
    flash_attention_fwd,
    flash_attention_plain,
)
from halva_tpu_torch.ops.generate import (
    _prefill_impl,
    generate_greedy,
    init_gen_cache_like,
)
from halva_tpu_torch.ops.w4_matmul import (
    quantize_params_int4,
    w4_dense_stacked,
    w4_dense_stacked_plain,
)
from halva_tpu_torch.train.lora import add_lora
from halva_tpu_torch.train.trainer import (
    TrainConfig,
    dpa_step_fns,
    init_train_state,
)

CFG = LLAVA_V15_7B  # the train phase's model
DEVICE = "cuda"

# bf16 kernel vs plain version on the same bf16 inputs, elementwise
# |got - plain| <= KERNEL_ATOL + KERNEL_RTOL * |plain|, and the relative
# norm of the difference <= KERNEL_RTOL. Both round the output to bf16 (one
# step is 2^-8..2^-7 relative); the kernels also round P to bf16 for the
# tensor-core PV product, as the Pallas kernels do.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
LSE_MAX_ABS = 1e-3  # fp32 statistic: only the summation order differs
# K2/K3 (flash backward) vs flash_attention_bwd_plain, which rounds P and dS
# to bf16 where the kernels do: elementwise |got - plain| <= BWD_RTOL *
# (max|plain| + |plain|) on live rows, relative norm <= BWD_REL. What is left
# is the bf16 rounding of the outputs and of the few P or dS elements whose
# fp32 values (exp2 of a pre-scaled logit in the kernels, exp in the plain
# version, other summation orders) straddle a bf16 rounding boundary.
BWD_RTOL = 2e-2
BWD_REL = 2e-3
# first-token logits of the kernel path vs the plain path, 32 bf16 layers:
# the attention outputs differ by the P rounding above, and the difference
# travels through every later layer's bf16 activations
LOGITS_REL = 2e-2
# decode-step logits of the int4g tree, kernel path (K6, K4 int4/int8) vs
# plain path on one prompt cache: the kernels sum in another order and skip
# the plain version's bf16 rounding of probability * v scale; the
# difference travels through 32 bf16 layers like any bf16-level
# perturbation, whose effect the smoke measures beside it (the noise floor:
# plain path vs plain path with the token embeddings perturbed by 2^-7
# N(0, 1) relative). Measured on an H100: 1.81-1.84e-2 against a floor of
# 1.85-1.87e-2; the bound is 4/3 of the floor, as LOGITS_REL is of the
# bf16 tree's floor of ~1.5e-2.
LOGITS_REL_W4 = 2.5e-2
# DPA train step, kernel path vs plain path (attn_impl="plain") on one
# micro-step: the alignment loss, the KL and the LoRA grads by relative
# error, each within TRAIN_FLOOR_FACTOR of its noise floor (plain path vs
# plain path with the text-token embeddings perturbed by 2^-7 N(0, 1)
# relative), the rule LOGITS_REL and LOGITS_REL_W4 follow
TRAIN_FLOOR_FACTOR = 4 / 3
W4_GROUP = 128  # the int4g serving tree's group size

PROMPT_LENS = (623, 615, 608, 623)  # spliced lengths of the 48/40/33/48 prompts
TEXT_LENS = (48, 40, 33, 48)  # the requests' text tokens, image sentinel at 1
NEW_TOKENS = 32
# the DPA train step: 512 text tokens, the image sentinel at 1 -> 1087 spliced
TRAIN_TEXT = 512
TRAIN_SPLICED = TRAIN_TEXT + LLAVA_V15_7B.num_image_tokens - 1
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


@functools.lru_cache(maxsize=None)
def side_stream() -> torch.cuda.Stream:
    # one for the whole run: cuBLAS keeps a workspace for every stream used
    return torch.cuda.Stream()


def device_ms(fn, iters: int = 20) -> float:
    """Median device time of fn's launches, replayed from one CUDA graph: the
    graph issues them back to back, so the host's per-call work (the Python
    wrappers take tens of us) does not show in the time of a short kernel."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = timed_ms(graph.replay, iters=iters)
    del graph
    return ms


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
            ms = device_ms(lambda: flash_attention_fwd(*args, causal=True))
            plain_ms = device_ms(
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


def check_flash_bwd(gen: torch.Generator) -> list:
    """K2 and K3 against flash_attention_bwd_plain at the DPA train shape
    (B=4 rows of 1087 spliced tokens, H=32, D=128), on K1's o and LSE, with
    padded rows; then a GQA (KVH=8) and a packed-segment case."""
    dev = "cuda"
    b, s, h, d = 4, TRAIN_SPLICED, 32, 128
    lens = (s, s - 7, s - 64, s - 301)  # padded rows
    worst = {"dq": 0.0, "dkv": 0.0}
    timing = {}
    for kvh, seg_kind in ((32, "pad"), (8, "pad"), (32, "packed")):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device=dev).bfloat16()

        q, k, v, do = r(b, s, h, d), r(b, s, kvh, d), r(b, s, kvh, d), r(
            b, s, h, d)
        seg = lengths_to_seg(lens, s, dev)
        if seg_kind == "packed":  # two documents in every row
            seg = seg * (1 + (torch.arange(s, device=dev) >= 500).int())
        live = seg != 0
        do[~live] = 0  # dead rows never reach a loss
        o, lse = flash_attention_fwd(q, k, v, seg, seg)
        delta = flash_attention_delta(o, do)
        args = (q, k, v, seg, seg, do, lse, delta)
        got = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
        want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do)
        torch.cuda.synchronize()
        line = []
        ok = True
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g[live].float(), w[live].float()
            err, rel = max_abs(g, w), rel_err(g, w)
            bound = BWD_RTOL * (w.abs().max() + w.abs())
            ok = ok and bool((g - w).abs().le(bound).all()) and (
                rel <= BWD_REL) and bool(torch.isfinite(g).all())
            kernel = "dq" if name == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], err)
            line.append(f"{name} max_abs_err {err:.3e} rel {rel:.3e}")
        print(f"flash_bwd B={b} S={s} H={h} KVH={kvh} D={d} causal {seg_kind}"
              f": {', '.join(line)} (limits {BWD_RTOL}*(max|plain| + "
              f"|plain|), rel {BWD_REL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_bwd disagrees with its plain version")
        if kvh == h and seg_kind == "pad":
            timing["dq"] = device_ms(lambda: flash_attention_bwd_dq(*args))
            timing["dkv"] = device_ms(lambda: flash_attention_bwd_dkv(*args))
            timing["plain"] = device_ms(lambda: flash_attention_bwd_plain(
                q, k, v, seg, seg, o, lse, do))
            pairs = h * sum(n * (n + 1) / 2 for n in lens)
            # 2 * D FLOP per live (query, key) pair for each product: K2
            # computes S, dP and dQ, K3 S, dP, dV and dK
            print(f"flash_bwd time: K2 (dq) {timing['dq']:.4f} ms, "
                  f"{3 * 2 * d * pairs / timing['dq'] / 1e9:.1f} TFLOP/s; "
                  f"K3 (dk, dv) {timing['dkv']:.4f} ms, "
                  f"{4 * 2 * d * pairs / timing['dkv'] / 1e9:.1f} TFLOP/s; "
                  f"plain backward (dq, dk, dv together) "
                  f"{timing['plain']:.4f} ms; on live causal pairs")
        del q, k, v, do, o, lse, delta, got, want
    common = {"route": "cuda", "source": "halva_tpu_torch/csrc/flash_bwd.cu",
              "plain_ms": timing["plain"]}
    return [
        {"name": "flash_bwd_dq", "replaces":
         "halva_tpu/ops/flash_attention.py:206", "max_abs_err": worst["dq"],
         "ms": timing["dq"], **common},
        {"name": "flash_bwd_dkv", "replaces":
         "halva_tpu/ops/flash_attention.py:279", "max_abs_err": worst["dkv"],
         "ms": timing["dkv"], **common},
    ]


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

        ms = device_ms(lambda: walk(decode_attend_layer)) / layers
        plain_ms = device_ms(lambda: walk(decode_attend_plain)) / layers
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


def _quant_caches(gen, mode, layers, b, kvh, sp, sg, d):
    """Stacked random int8 (kv8) or int4 (kv4) prompt caches and int8 gen
    caches of random bytes, with bf16 scales near the dequantized values'
    unit size."""
    dev = "cuda"

    def rbytes(*shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def sc(*shape, lo=0.01, hi=0.04):
        return (torch.rand(*shape, generator=gen, device=dev) * (hi - lo)
                + lo).bfloat16()

    if mode == "kv4":
        s2 = -(-sp // 2)
        pc = {"k4": rbytes(layers, b, kvh, s2, d, lo=-128),
              "v4": rbytes(layers, b, kvh, s2, d, lo=-128),
              "k_scale": sc(layers, b, 2, kvh, s2, lo=0.1, hi=0.3),
              "v_scale": sc(layers, b, 2, kvh, s2, lo=0.1, hi=0.3)}
    else:
        pc = {"k": rbytes(layers, b, kvh, sp, d),
              "v": rbytes(layers, b, kvh, sp, d),
              "k_scale": sc(layers, b, kvh, sp),
              "v_scale": sc(layers, b, kvh, sp)}
    gc = {"k": rbytes(layers, b, kvh, sg, d), "v": rbytes(layers, b, kvh, sg, d),
          "k_scale": sc(layers, b, kvh, sg), "v_scale": sc(layers, b, kvh, sg)}
    return pc, gc


def check_decode_quant(gen: torch.Generator) -> list:
    """K4's int8-prompt/int8-gen and int4-prompt/int8-gen modes against
    decode_attend_plain at the 7B decode shape (odd Sp = 623)."""
    dev = "cuda"
    b, h, sp, sg, d, layers = 4, 32, 623, 128, 128, 8
    steps = torch.tensor([0, 37, 100, 127], device=dev)
    gen_valid = torch.arange(sg, device=dev)[None, :] <= steps[:, None]
    seg = lengths_to_seg(PROMPT_LENS, sp, dev)
    out = []
    for mode in ("kv8", "kv4"):
        name = "decode_attn_" + mode
        worst = 0.0
        for kvh in (32, 8):
            q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
            pc, gc = _quant_caches(gen, mode, layers, b, kvh, sp, sg, d)

            def call(fn, li):
                return fn(q, {k: v[li] for k, v in pc.items()}, seg,
                          {k: v[li] for k, v in gc.items()}, gen_valid)

            err = rel = 0.0
            ok = True
            for li in (0, layers - 1):
                got = call(decode_attend_layer, li)
                want = call(decode_attend_plain, li)
                torch.cuda.synchronize()
                err = max(err, max_abs(got, want))
                rel = max(rel, rel_err(got, want))
                ok = ok and within(got, want) and bool(
                    torch.isfinite(got).all())
            print(f"{name} B={b} H={h} KVH={kvh} Sp={sp} Sg={sg} D={d}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (limits {KERNEL_ATOL}"
                  f" + {KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            worst = max(worst, err)
            if kvh != h:
                continue

            def walk(fn):
                for li in range(layers):
                    call(fn, li)

            ms = device_ms(lambda: walk(decode_attend_layer)) / layers
            plain_ms = device_ms(lambda: walk(decode_attend_plain)) / layers
            # k + v (+ their scales) bytes of one live position, all heads
            prompt_row = kvh * (d if mode == "kv4" else 2 * d) + 4 * kvh
            gen_row = kvh * 2 * d + 4 * kvh
            read = (sum(PROMPT_LENS) * prompt_row
                    + int((steps + 1).sum()) * gen_row)
            print(f"{name} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms;"
                  f" {read / 1e6:.2f} MB live -> {read / ms / 1e6:.0f} GB/s "
                  "live")
            timing = (ms, plain_ms)
        out.append({"name": name, "route": "cuda",
                    "source": "halva_tpu_torch/csrc/decode_attn.cu",
                    "replaces": "halva_tpu/ops/decode_attention.py:82",
                    "max_abs_err": worst, "ms": timing[0],
                    "plain_ms": timing[1]})
    return out


# (K, N) of the 7B decode matmuls: wq/wk/wv/wo, gate/up, down
W4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))


def check_w4(gen: torch.Generator) -> dict:
    """K6 against w4_dense_stacked_plain at the 7B decode matmul shapes,
    per-channel and g=128 scales, B = 4 (the smoke's batch) and 80 (the
    reference's serving batch). The JSON line carries gate/up at B=4,
    g=128."""
    dev = "cuda"
    layers = 4
    worst = 0.0
    for k, n in W4_SHAPES:
        np_ = n // 2
        # random bytes: every nibble occurs, -8 included; `layers` distinct
        # weights so that timed calls read device memory, not L2
        w = torch.randint(-128, 128, (layers, k, np_), generator=gen,
                          device=dev, dtype=torch.int8)
        for groups in (1, k // W4_GROUP):
            s = (torch.rand(layers, 2, groups, np_, generator=gen,
                            device=dev) * 0.02 + 0.005).bfloat16()
            for b in (4, 80):
                x = torch.randn(b, k, generator=gen, device=dev).bfloat16()

                def call(fn, li):
                    return fn(x, {"kernel_q4p": w[li],
                                  "kernel_scale4p": s[li]})

                def walk(fn):
                    for li in range(layers):
                        call(fn, li)

                err = rel = 0.0
                ok = True
                for li in (0, layers - 1):
                    got = call(w4_dense_stacked, li)
                    want = call(w4_dense_stacked_plain, li)
                    torch.cuda.synchronize()
                    err = max(err, max_abs(got, want))
                    rel = max(rel, rel_err(got, want))
                    ok = ok and within(got, want) and bool(
                        torch.isfinite(got).all())
                ms = device_ms(lambda: walk(w4_dense_stacked)) / layers
                plain_ms = device_ms(lambda: walk(w4_dense_stacked_plain))
                plain_ms /= layers
                nbytes = k * np_ + 2 * groups * np_ * 2
                print(f"w4_gemv B={b} K={k} N={n} G={groups}: max_abs_err "
                      f"{err:.3e} rel {rel:.3e} (limits {KERNEL_ATOL} + "
                      f"{KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}); kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms; "
                      f"{nbytes / 1e6:.2f} MB packed weights + scales -> "
                      f"{nbytes / ms / 1e6:.0f} GB/s {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("w4_gemv disagrees with its plain "
                                         "version")
                worst = max(worst, err)
                if (k, n, groups, b) == (4096, 11008, 4096 // W4_GROUP, 4):
                    timing = (ms, plain_ms)
        del w
    return {"name": "w4_gemv", "route": "cuda",
            "source": "halva_tpu_torch/csrc/w4_gemv.cu",
            "replaces": "halva_tpu/ops/w4_matmul.py:313",
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


def run_bf16(kernels: dict) -> dict:
    """The bf16 main path at full width, then the plain path beside it.
    Returns the bf16 param tree."""
    cfg = LLAVA_V15_7B
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlavaModel(cfg, tree.init_params(cfg, gen, torch.bfloat16, "cuda"))
    params = model.params
    n_params = sum(t.numel() for _, t in tree.flatten(params))
    torch.cuda.synchronize()
    print(f"model: llava-v1.5-7b, {cfg.llm.num_layers} layers, hidden "
          f"{cfg.llm.hidden_size}, CLIP ViT-L/14-{cfg.vision.image_size}; "
          f"{n_params / 1e9:.3f} B random bf16 params from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s ({before / 2**30:.2f} GiB "
          "allocated before them)")
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
    for name in want:
        kernels[name]["launches"] = launches[name]
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
    return params


def tree_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree.flatten(params))


def quantize_int4g(params: dict) -> dict:
    """The int4g serving tree, quantized on the card from the bf16 tree."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q4 = quantize_params_int4(params, group_size=W4_GROUP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    print(f"int4g tree: quantize_params_int4(group_size={W4_GROUP}) on the "
          f"card in {secs:.2f} s, {tree_bytes(params) / 1e9:.3f} GB bf16 -> "
          f"{tree_bytes(q4) / 1e9:.3f} GB")
    return q4


def expect_launches(launches: dict, want: dict, what: str) -> None:
    ok = launches == want
    print(f"launches in the {what}: {launches} (expected {want}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {what} did not run every kernel")


def run_int4g(q4: dict, kernels: dict) -> None:
    """The int4g serving path at full width (int4 prompt KV), a short int8
    KV run, then the plain path beside the kernel path."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]
    with torch.inference_mode():
        generate_greedy(q4, cfg, *inputs, max_new_tokens=2, eos_id=-1,
                        kv_quant="int4")  # warm-up, not counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _prefill_impl(q4, cfg, *inputs, kv_quant="int4")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0

        # the int4g main path; counts start at 0 right before it
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        tokens, num = generate_greedy(q4, cfg, *inputs,
                                      max_new_tokens=NEW_TOKENS, eos_id=-1,
                                      kv_quant="int4")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        peak = torch.cuda.max_memory_allocated()
    # one K1 per layer per prefill, one K4 per layer per decode step, K6 for
    # each of the 7 matmuls of a layer per decode step
    expect_launches(launches, {
        "flash_fwd": layers, "decode_attn_kv4": layers * NEW_TOKENS,
        "w4_gemv": 7 * layers * NEW_TOKENS}, "int4g main run")
    for name in ("decode_attn_kv4", "w4_gemv"):
        kernels[name]["launches"] = launches[name]
    tok_ok = bool(((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()
                  and (num == NEW_TOKENS).all())
    print(f"int4g tokens: shape {tuple(tokens.shape)}, all in [0, "
          f"{cfg.llm.vocab_size}), {NEW_TOKENS} per row "
          f"{'ok' if tok_ok else 'FAIL'}")
    if not tok_ok:
        raise AssertionError("int4g tokens out of range")
    decode_s = total_s - prefill_s
    print(f"int4g main path: prefill {prefill_s * 1e3:.2f} ms (B={b}, "
          f"{max(PROMPT_LENS)} spliced tokens, int4 prompt KV), decode "
          f"{decode_s / NEW_TOKENS * 1e3:.3f} ms/step, "
          f"{b * NEW_TOKENS / decode_s:.1f} decode tokens/s, "
          f"{b * NEW_TOKENS / total_s:.1f} tokens/s end to end "
          f"({total_s:.3f} s), peak memory {peak / 2**30:.2f} GiB")

    # int8 prompt KV: the same tree, K4 in its int8/int8 mode
    kv8_tokens = 4
    with torch.inference_mode():
        _kernels.reset_launches()
        tok8, _ = generate_greedy(q4, cfg, *inputs, max_new_tokens=kv8_tokens,
                                  eos_id=-1, kv_quant="int8")
        torch.cuda.synchronize()
        launches = dict(_kernels.launches)
    expect_launches(launches, {
        "flash_fwd": layers, "decode_attn_kv8": layers * kv8_tokens,
        "w4_gemv": 7 * layers * kv8_tokens}, "int8-KV run")
    kernels["decode_attn_kv8"]["launches"] = launches["decode_attn_kv8"]
    if not bool(((tok8 >= 0) & (tok8 < cfg.llm.vocab_size)).all()):
        raise AssertionError("int8-KV tokens out of range")

    # kernel path vs plain path: copies of one int4 prompt cache, the main
    # run's tokens, so only K6 and K4 differ; beside them the noise floor,
    # the plain path with its token embeddings perturbed at the bf16 level
    noise = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        _, _, slen, pc, pseg = _prefill_impl(q4, cfg, *inputs,
                                             kv_quant="int4")
        runs = {}
        for run, impl in (("auto", "auto"), ("plain", "plain"),
                          ("floor", "plain")):
            cache = {k: v.clone() for k, v in pc.items()}
            gen_cache = init_gen_cache_like(cfg.llm, b, NEW_TOKENS, cache)
            logits = []
            for step in range(COMPARE_STEPS):
                emb = llama.embed(q4["llm"], tokens[:, step, None])
                if run == "floor":
                    eps = torch.randn(emb.shape, generator=noise,
                                      device="cuda")
                    emb = (emb.float() * (1 + 2**-7 * eps)).to(emb.dtype)
                lg, gen_cache = llama.decode_step(
                    q4["llm"], cfg.llm, emb, slen + step, cache, pseg,
                    gen_cache, step, attn_impl=impl)
                logits.append(lg)
            runs[run] = torch.stack(logits)  # (steps, B, V)
            del cache, gen_cache
    finite = all(bool(torch.isfinite(r).all()) for r in runs.values())
    step_rel = [rel_err(runs["auto"][i], runs["plain"][i])
                for i in range(COMPARE_STEPS)]
    floor = [rel_err(runs["floor"][i], runs["plain"][i])
             for i in range(COMPARE_STEPS)]
    agree = float((runs["auto"].argmax(-1) == runs["plain"].argmax(-1))
                  .float().mean())
    ok = finite and max(step_rel) <= LOGITS_REL_W4
    print("int4g kernel vs plain path: decode steps 0-"
          f"{COMPARE_STEPS - 1} logits rel err "
          + ", ".join(f"{e:.3e}" for e in step_rel)
          + f" (limit {LOGITS_REL_W4}); noise floor (plain vs plain with "
          "embeddings x (1 + 2^-7 N(0,1))) "
          + ", ".join(f"{e:.3e}" for e in floor)
          + f"; greedy agreement {agree:.3f} over {COMPARE_STEPS} steps x "
          f"{b} rows; logits finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int4g kernel path disagrees with the plain path")


TRAIN_B = 2  # micro-batch: 2B rows in the pos+neg forward
TRAIN_MICRO_STEPS = 4  # two updates at grad_accum_steps=2
LORA_B_STD = 1e-3  # comparison tree's lora_b: ~2 % of a layer's output


def train_batch(cfg, seed: int) -> dict:
    """A synthetic DPA batch as scripts/bench_train7b.py:build_batch makes it:
    TRAIN_B rows of TRAIN_TEXT tokens with the image sentinel at 1, labels
    on the second half, two phrase spans, random pixels."""
    rng = np.random.RandomState(seed)
    b, t = TRAIN_B, TRAIN_TEXT
    hi = min(30000, cfg.llm.vocab_size)

    def grp():
        ids = rng.randint(5, hi, (b, t)).astype(np.int32)
        ids[:, 1] = IMAGE_TOKEN_INDEX
        seg = np.ones((b, t), np.int32)
        lab = ids.copy()
        lab[:, : t // 2] = IGNORE_INDEX
        sg = np.zeros((b, t), np.int32)
        sg[:, t // 2: t // 2 + 3] = 1
        sg[:, t // 2 + 4: t // 2 + 7] = 2
        return ids, seg, lab, sg

    i1, s1, l1, g1 = grp()
    i2, s2, l2, g2 = grp()
    i3, s3, l3, _ = grp()
    img = cfg.vision.image_size
    batch = dict(
        input_ids=i1, segment_ids=s1, labels=l1, pos_signs=g1,
        neg_input_ids=i2, neg_segment_ids=s2, neg_labels=l2, neg_signs=g2,
        ref_input_ids=i3, ref_segment_ids=s3, ref_labels=l3,
        images=rng.randn(b, 3, img, img).astype(np.float32),
        ref_images=rng.randn(b, 3, img, img).astype(np.float32))
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def bit_sums(params) -> dict:
    """An exact checksum per leaf: the int64 sum of its bit patterns, taken
    in slices of 2^24 elements (a whole stacked leaf in int64 would be
    11.5 GB)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    out = {}
    for path, t in tree.flatten(params):
        flat = t.detach().reshape(-1).view(ints[t.element_size()])
        out[path] = sum(int(c.sum(dtype=torch.int64))
                        for c in flat.split(1 << 24))
    return out


def changed(before: dict, after: dict) -> list:
    return [p for p in before if before[p] != after[p]]


def run_train(params: dict, kernels: dict) -> None:
    """The DPA LoRA train step of llava-v1.5-7b at full width: bf16 base,
    bf16 LoRA r=128 alpha=256 on the 7 linears of all layers, remat per
    layer, loss_chunk=256, micro-batch 2, AdamW with warmup and cosine
    decay, grad_accum_steps=2; TRAIN_MICRO_STEPS micro-steps. Then one
    micro-step on the kernel path against the plain path."""
    cfg = CFG
    layers = cfg.llm.num_layers
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    policy = add_lora(params, gen, rank=128, alpha=256.0)
    tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400, remat=True,
                       loss_chunk=256)
    trainable, frozen, opt, opt_state = init_train_state(policy, tcfg)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    batches = [train_batch(cfg, seed) for seed in range(TRAIN_MICRO_STEPS)]
    n_lora = sum(t.numel() for _, t in tree.flatten(trainable)
                 if t is not None)
    sums = [bit_sums(policy)]

    # the main path; counts start at 0 right before it, read after each
    # micro-step; the peak memory is that of the micro-steps alone (the
    # checksums between them are not the step's)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    seen = {}
    times = []
    peak = 0
    for i, batch in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainable, opt_state, m = step(trainable, frozen, None, opt_state,
                                       batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        now = dict(_kernels.launches)
        per_step = {k: now[k] - seen.get(k, 0) for k in now}
        seen = now
        vals = [float(x) for x in m]
        ok = all(np.isfinite(vals)) and vals[3] > 0
        print(f"train micro-step {i}: loss {vals[0]:.6f} alignment "
              f"{vals[1]:.6f} kl {vals[2]:.3e} grad_norm {vals[3]:.4e}; "
              f"{times[-1] * 1e3:.1f} ms; updates applied {opt.updates} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train step: a loss is not finite or the "
                                 "grad norm is 0")
        # per layer: K1 in the pos+neg, policy-ref and frozen-ref forwards
        # and in the remat recompute of the two forwards with grad; K2 and
        # K3 in the backward of those two
        expect_launches(per_step, {"flash_fwd": 5 * layers,
                                   "flash_bwd_dq": 2 * layers,
                                   "flash_bwd_dkv": 2 * layers},
                        f"train micro-step {i}")
        if opt.updates and i % tcfg.grad_accum_steps == 1:
            sums.append(bit_sums(policy))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        kernels[name]["launches"] = seen.get(name, 0)

    lora_paths = {p for p, t in tree.flatten(trainable) if t is not None}
    first, second = changed(sums[0], sums[1]), changed(sums[1], sums[2])
    ok = (opt.updates == 2 and not first and second
          and set(second) <= lora_paths)
    print(f"train updates: {opt.updates}; leaves changed by update 1 (lr(0) "
          f"= 0): {len(first)}; by update 2: {len(second)} of "
          f"{len(lora_paths)} LoRA leaves ({n_lora / 1e6:.1f} M params), "
          f"{len(set(second) - lora_paths)} others "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the optimizer changed other leaves than LoRA's,"
                             " or none")
    steady = times[1:]
    print(f"train main path ({gpu_line()}): "
          f"{statistics.mean(steady) * 1e3:.1f} ms per micro-step (mean of "
          f"micro-steps 1-{len(times) - 1}; all: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" ms), B={TRAIN_B} rows of {TRAIN_SPLICED} spliced tokens, "
          f"peak memory {peak / 2**30:.2f} GiB")
    del policy, trainable, frozen, opt, opt_state, step
    compare_train(params, batches[0])


def compare_train(params: dict, batch: dict) -> None:
    """One micro-step's loss parts and LoRA grads, kernel path against plain
    path, beside the noise floor; on a tree whose lora_b is small and
    nonzero (at B = 0 the KL and the lora_a grads are exactly 0)."""
    cfg = CFG
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cmp = add_lora(params, gen, rank=128, alpha=256.0)
    for group in ("attn", "mlp"):
        for p in cmp["llm"]["layers"][group].values():
            p["lora_b"] = (torch.randn(p["lora_b"].shape, generator=gen,
                                       device=DEVICE) * LORA_B_STD).to(
                                           p["lora_b"].dtype)
    runs = {}
    tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400, remat=True,
                       loss_chunk=256)
    trainable, frozen, opt, _ = init_train_state(cmp, tcfg)
    table = frozen["llm"]["embed"]["embedding"]
    noise = torch.Generator(device=DEVICE).manual_seed(3)
    eps = torch.randn(table.shape, generator=noise, device=DEVICE)
    floor_frozen = tree.map_tree(lambda x: x, frozen)
    floor_frozen["llm"]["embed"]["embedding"] = (
        table.float() * (1 + 2**-7 * eps)).to(table.dtype)
    del eps
    for run, impl, frz in (("kernel", "auto", frozen),
                           ("plain", "plain", frozen),
                           ("floor", "plain", floor_frozen)):
        step, _ = dpa_step_fns(cfg, dataclasses.replace(tcfg, attn_impl=impl),
                               opt)
        _, parts, grads = step.loss_and_grads(trainable, frz, None, batch)
        runs[run] = (float(parts.alignment), float(parts.divergence),
                     [g for _, g in tree.flatten(grads) if g is not None])
        torch.cuda.synchronize()

    def errs(run):
        got, want = runs[run], runs["plain"]
        g = torch.cat([x.float().flatten() for x in got[2]])
        w = torch.cat([x.float().flatten() for x in want[2]])
        return (abs(got[0] - want[0]) / abs(want[0]),
                abs(got[1] - want[1]) / abs(want[1]), rel_err(g, w))

    got, floor = errs("kernel"), errs("floor")
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in
                 runs.values())
    ok = finite and all(e <= TRAIN_FLOOR_FACTOR * f
                        for e, f in zip(got, floor))
    names = ("alignment", "kl", "LoRA grads")
    print("train kernel vs plain path (one micro-step, lora_b ~ "
          f"{LORA_B_STD} N(0,1)): plain alignment {runs['plain'][0]:.6f}, "
          f"kl {runs['plain'][1]:.4e}; rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, got))
          + "; noise floor (plain vs plain with the text embeddings x (1 + "
          "2^-7 N(0,1))) "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, floor))
          + f"; bound {TRAIN_FLOOR_FACTOR:.3f} x floor "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train kernel path disagrees with the plain path")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    # fp32 matmuls and convolutions in full fp32 (cuDNN convolutions default
    # to TF32, ~3 decimal digits), so every plain reference is exact fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_line())
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checked = [check_flash(gen), *check_flash_bwd(gen), check_decode(gen),
               *check_decode_quant(gen), check_w4(gen)]
    kernels = {k["name"]: k for k in checked}
    params = run_bf16(kernels)
    run_train(params, kernels)
    torch.cuda.empty_cache()
    q4 = quantize_int4g(params)
    del params  # the bf16 tree is freed here
    torch.cuda.empty_cache()
    run_int4g(q4, kernels)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "halva_tpu")
    if "jax" in sys.modules or set(loaded) - {
            "halva_tpu", "halva_tpu.config", "halva_tpu.constants"}:
        raise AssertionError(f"JAX code was imported: {loaded}")
    print(f"imports: no jax; from halva_tpu only the framework-free {loaded}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in checked]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
