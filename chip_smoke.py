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
int8/int8). On both trees it then drives beam search (`generate_beam`,
4 beams: K5's per-beam gen stage, and K4's beam mode as the other route)
and speculative greedy decode (`generate_speculative`, draft_k 4, and 8 over
200 tokens with a 256-slot gen cache: K5's shared gen stage, K6 at B*K
rows), asserts their launch counts, and prints the beam step beside the
greedy step (with the device time of the beam loop's selection and
gen-cache reorder), the verify step beside the decode step, and the two
beam routes against each other at batch 4 and at batch 80. Beside each
kernel's time it prints the least time the card could take for the same
work (bytes over 3.35 TB/s or FLOP over 989 TFLOP/s, whichever is larger)
and, where one PyTorch call computes the same function
(`scaled_dot_product_attention`), that call's time as a yardstick; the
port itself never calls it. Then the two other model families at 7B width
and depth, each from its own random bf16 tree: Mistral-7B (GQA 32 over 8
heads, sliding window 4096: K1, K2 and K3 in window mode, K4 at G=4, a
4,608-token text row that outgrows the window and decodes through the
position-aware plain attention, a short int4g run: K6 and K4 int4 at
Mistral's shapes) and MPT-7B (ALiBi, LayerNorm, non-gated GELU MLP, tied
embeddings: K1, K2 and K3 in ALiBi mode, decode through the plain attention
with the bias, as the JAX package computes it), served and trained; before
them K1, K2 and K3 are held against their plain versions in the ALiBi,
sliding-window modes and with a q_offset.

The quantized frozen bases: K7 (the M-tiled packed-int4 GEMM) and K8 (the
weight-only int8 GEMM) are held against their plain versions at the 7B and
Mistral shapes from 9 to 4,348 rows, timed beside K6, beside dequantize +
torch.matmul and beside W8A8's torch._int_mm. From the llava bf16 tree an
int8 tree, an NF4 tree and the int4g tree are quantized on the card. The
int8 tree is served on both its routes (weight-only: K8 for every quantized
dense of the tower, the projector, the LLM and lm_head; W8A8: no K8 launch),
one decode step of each timed on the device. The DPA LoRA train step then
takes 2 micro-steps on each of the three bases (frozen tree as the KL
reference), with the launches, finite losses and LoRA-only updates of the
bf16 phase asserted, and one micro-step's LoRA grads on each base are held
against the same micro-step on that base dequantized to a bf16 tree, beside
a noise floor: a quantized dense whose backward is missing reads a relative
error near 1 there. On the int4g tree the beam and verify steps (16 and 32
rows) send their layer matmuls to K7 by the row rule W4_GEMV_MAX_ROWS, as
does a short greedy run at batch 80; each step is timed on K7 and on K6.
Every phase prints one line; any failure raises and exits non-zero. The
last line is the device record {"ok": true, "device": {...}}.

    python3 chip_smoke.py --flash-only

builds the kernels, runs only the checks and timings of K1, K2 and K3 (all
three also in the base mode on the 4,608-token row beside SDPA and its
backward, their bitwise repeat and CUDA-graph replay, their launch plans
beside each time) and prints their rows: two builds of the flash kernels
are compared by running this from each tree in turn on one card (an older
tree prints no plans).

    python3 chip_smoke.py --decode-only

builds the kernels, runs only K4's checks and timings (bf16, int8/int8,
int4/int8 and the beam mode at B=4, int4/int8 at batch 80, and the B=4
shapes under forced key-axis plans) and prints their rows.

    python3 chip_smoke.py --fold-only

builds the kernels, runs only K5's checks and timings (both stages, every
mode, MHA and GQA, forced key-axis plans, K4's beam route beside it at B=4
and at batch 80, the route "auto" takes) and prints their rows.

    python3 chip_smoke.py --gemm-only

builds the kernels, runs only the checks and timings of K7 and K8 (every
row count, each line with its launch plan; forced split plans at CLIP's
tower shape and at batch 80; the wrappers' host time per call on each
path) and the batch-80 int4g decode step on a fresh random tree: two
builds of csrc/dq_gemm.cu are compared by running this script from each
tree in turn on one card (an older tree prints no plans).

    python3 chip_smoke.py --quant-only

runs only the quantized-base part (the checks of K7 and K8, the int8
serving routes, the three train phases, the int4g serving, beam and verify
runs) on a fresh random tree, with the rows of K7 and K8 alone.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import collections
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from halva_tpu_torch import _kernels, tree
from halva_tpu_torch.config import (
    CLIP_VIT_L_336,
    LLAVA_V15_7B,
    MISTRAL_7B,
    MPT_7B,
    LlavaConfig,
)
from halva_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from halva_tpu_torch.models import llama, llava
from halva_tpu_torch.models.llava import LlavaModel
from halva_tpu_torch.ops import int8_matmul as int8_ops
from halva_tpu_torch.ops import quant, w4_matmul
from halva_tpu_torch.ops.attention import (
    alibi_in_kernel,
    attention,
    causal_alibi_bias,
    kernel_route,
    make_attention_mask,
)
from halva_tpu_torch.ops.beam import (generate_beam, init_beam_state,
                                      reorder_gen_cache, select_step)
from halva_tpu_torch.ops.decode_attention import (
    auto_beam_route,
    decode_attend_layer,
    decode_attend_plain,
    decode_plan,
    fold_attend_layer,
    fold_attend_plain,
    fold_attend_split_plain,
    fold_plan,
    sm_count,
)
from halva_tpu_torch.ops import flash_attention as flash_ops
from halva_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_delta,
    flash_attention_fwd,
    flash_attention_plain,
)
from halva_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from halva_tpu_torch.ops.generate import (
    _prefill_impl,
    generate_greedy,
    init_gen_cache_like,
)
from halva_tpu_torch.ops.speculative import generate_speculative
from halva_tpu_torch.ops.w4_matmul import (
    dequantize_int4,
    quantize_params_int4,
    w4_dense_stacked,
    w4_dense_stacked_plain,
    w4_gemm,
    w4_gemm_plain,
)
from halva_tpu_torch.train.lora import add_lora
from halva_tpu_torch.train.trainer import (
    TrainConfig,
    dpa_step_fns,
    init_train_state,
)

CFG = LLAVA_V15_7B  # the first train phase's model
# VILA's llava_mistral and llava_mpt compositions at 7B
LLAVA_MISTRAL_7B = LlavaConfig(llm=MISTRAL_7B, vision=CLIP_VIT_L_336)
LLAVA_MPT_7B = LlavaConfig(llm=MPT_7B, vision=CLIP_VIT_L_336)
DEVICE = "cuda"

# bf16 kernel vs plain version on the same bf16 inputs, elementwise
# |got - plain| <= KERNEL_ATOL + KERNEL_RTOL * |plain|, and the relative
# norm of the difference <= KERNEL_RTOL. Both round the output to bf16 (one
# step is 2^-8..2^-7 relative); the decode kernels also round P to bf16 for
# the tensor-core PV product, as the Pallas kernels do (K1 keeps ~16 bits
# of P as two bf16 terms).
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
# W8A8 against the weight-only route of the int8 tree, and the LoRA grads of
# a W8A8 base against the dequantized bf16 tree: int8_dense rounds the
# activations of every dense to 127 steps of the row's absmax, a
# perturbation at every layer where the floor's is one at the embeddings
W8A8_FLOOR_FACTOR = 4.0
W4_GROUP = 128  # the int4g serving tree's group size

PROMPT_LENS = (623, 615, 608, 623)  # spliced lengths of the 48/40/33/48 prompts
TEXT_LENS = (48, 40, 33, 48)  # the requests' text tokens, image sentinel at 1
NEW_TOKENS = 32
# the DPA train step: 512 text tokens, the image sentinel at 1 -> 1087 spliced
TRAIN_TEXT = 512
TRAIN_SPLICED = TRAIN_TEXT + LLAVA_V15_7B.num_image_tokens - 1
COMPARE_STEPS = 4  # decode steps re-run on the plain path
BEAMS = 4
BEAM_TOKENS_BF16 = 8  # the short beam run on the bf16 tree
SHORT_TOKENS = 4  # runs that only drive a further cache mode or route
SPEC_LONG = (8, 200)  # draft_k, tokens: a 256-slot gen cache
LONG_ROW = 4608  # a text-only Mistral row past its 4096 window
LONG_STEPS = 4  # decode steps on the long row
FAMILY_MICRO_STEPS = 2  # train micro-steps on the Mistral and MPT trees
FLOOR_DRAWS = 5  # perturbations behind each train noise floor
# the card's published peaks (H100 SXM data sheet), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations on these inputs over the bf16 tensor-core peak,
    whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def perturbed(t: torch.Tensor, noise) -> torch.Tensor:
    """t x (1 + 2^-7 N(0, 1)) in t's dtype, the bf16-level perturbation behind
    every noise floor; t itself when `noise` (a CUDA generator) is None."""
    if noise is None:
        return t
    eps = torch.randn(t.shape, generator=noise, device=t.device)
    return (t.float() * (1 + 2**-7 * eps)).to(t.dtype)


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
    """Builds the kernels; prints ptxas's registers, spills and shared
    memory for each entry function by name, and any wgmma it serialized."""
    t0 = time.perf_counter()
    _kernels.lib()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s for {', '.join(_kernels.SOURCES)}")
    entry = ""
    for ln in _kernels.build_log().splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill" in ln or "registers" in ln or "wgmma" in ln:
            print(f"  ptxas: {entry}: {ln}")


def k1_plan(b: int, sq: int, skv: int, h: int) -> str:
    """K1's launch plan as the wrapper picks it (an older tree, run for an
    A/B comparison, has none to report)."""
    plan_of = getattr(flash_ops, "flash_fwd_plan", None)
    if plan_of is None:
        return "plan: not reported by this tree"
    plan = plan_of(b, sq, skv, h)
    return (f"plan: {plan.bq}-row blocks, {plan.bk}-key tiles, "
            f"{plan.stages} stages, {plan.blocks} blocks")


def bwd_plan(b: int, sq: int, skv: int, h: int, kvh: int) -> str:
    """K2's and K3's launch plans as the wrappers pick them (an older tree,
    run for an A/B comparison, has none to report)."""
    plan_of = getattr(flash_ops, "flash_bwd_plan", None)
    if plan_of is None:
        return "K2/K3 plan: not reported by this tree"
    plan = plan_of(b, sq, skv, h, kvh, sms=sm_count(torch.device("cuda")))
    return (f"K2 plan: {plan.dq.rows}-row blocks, {plan.dq.tile}-key tiles, "
            f"{plan.dq.stages} stages, {plan.dq.blocks} blocks, "
            f"{plan.dq.order}; K3 plan: {plan.dkv.rows}-key blocks, "
            f"{plan.dkv.tile}-query tiles, {plan.dkv.stages} stages, "
            f"{plan.dkv.blocks} blocks, {plan.dkv.order}")


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
            # the yardstick: one SDPA call on (B, H, S, D) views under the
            # same causal + segment mask
            mask = ((seg[:, :, None] == seg[:, None, :])
                    & (seg[:, :, None] != 0)
                    & torch.ones(s, s, dtype=torch.bool, device=dev).tril())
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[:, None]))
            lim = bound(tensor_bytes(q, k, v, seg, o, lse), flops)
            print(f"flash_fwd time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, SDPA with the mask {lib_ms:.4f} ms, bound "
                  f"{lim['bound_ms']:.4f} ms by {lim['bound_by']}; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s on live causal pairs; "
                  f"{k1_plan(b, s, s, h)}")
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      **lim}
            del mask
    return {"name": "flash_fwd", "route": "cuda",
            "source": "halva_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "halva_tpu/ops/flash_attention.py:83",
            "max_abs_err": worst, **timing}


def check_flash_long(gen: torch.Generator) -> None:
    """K1, K2 and K3 in the base mode (causal, no window) on one 4,608-token
    row with Mistral's heads (H=32 over KVH=8) against their plain
    versions, timed beside one SDPA call and its backward (causal, the KV
    heads repeated outside the timed call); K1 beside the bound on its live
    pairs."""
    n, h, kvh, d = LONG_ROW, 32, 8, 128

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v = r(1, n, h, d), r(1, n, kvh, d), r(1, n, kvh, d)
    seg = torch.ones(1, n, dtype=torch.int32, device="cuda")
    o, lse = flash_attention_fwd(q, k, v, seg, seg)
    want = flash_attention_plain(q, k, v, seg, seg)
    torch.cuda.synchronize()
    err, rel = max_abs(o, want), rel_err(o, want)
    ok = within(o, want) and bool(torch.isfinite(lse).all())
    print(f"flash_fwd one {n}-token row H={h} KVH={kvh} causal: max_abs_err "
          f"{err:.3e} rel {rel:.3e} (limits {KERNEL_ATOL} + {KERNEL_RTOL}"
          f"*|plain|, rel {KERNEL_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version on "
                             "the long row")
    del want
    ms = device_ms(lambda: flash_attention_fwd(q, k, v, seg, seg))
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * h * d * n * (n + 1) / 2
    lim = bound(tensor_bytes(q, k, v, seg, o, lse), flops)
    print(f"flash_fwd one {n}-token row, causal, time: kernel {ms:.4f} ms, "
          f"SDPA (causal) {lib_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms by "
          f"{lim['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s; "
          f"{k1_plan(1, n, n, h)}")
    # K2 and K3 on the same row against the plain backward, timed beside
    # autograd's backward of the SDPA call above (dq, dk and dv together)
    do = r(1, n, h, d)
    delta = flash_attention_delta(o, do)
    args = (q, k, v, seg, seg, do, lse, delta)
    got = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    want = flash_attention_bwd_plain(q, k, v, seg, seg, o, lse, do)
    torch.cuda.synchronize()
    line, ok = [], True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err, rel = max_abs(g, w), rel_err(g, w)
        ok = ok and bool((g - w).abs().le(
            BWD_RTOL * (w.abs().max() + w.abs())).all()) and (
                rel <= BWD_REL) and bool(torch.isfinite(g).all())
        line.append(f"{name} max_abs_err {err:.3e} rel {rel:.3e}")
    print(f"flash_bwd one {n}-token row H={h} KVH={kvh} causal: "
          f"{', '.join(line)} (limits {BWD_RTOL}*(max|plain| + |plain|), "
          f"rel {BWD_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_bwd disagrees with its plain version on "
                             "the long row")
    del want, got
    dq_ms = device_ms(lambda: flash_attention_bwd_dq(*args))
    dkv_ms = device_ms(lambda: flash_attention_bwd_dkv(*args))
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = timed_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                                   retain_graph=True),
                       iters=10)
    del leaves, out, dot
    print(f"flash_bwd one {n}-token row, causal, time: K2 (dq) {dq_ms:.4f} "
          f"ms, {6 * h * d * n * (n + 1) / 2 / dq_ms / 1e9:.1f} TFLOP/s; K3 "
          f"(dk, dv) {dkv_ms:.4f} ms, "
          f"{8 * h * d * n * (n + 1) / 2 / dkv_ms / 1e9:.1f} TFLOP/s; "
          f"together {dq_ms + dkv_ms:.4f} ms, SDPA backward (causal, all "
          f"three) {lib_bwd:.4f} ms; {bwd_plan(1, n, n, h, kvh)}")


def repeats_and_replays(call, refill) -> bool:
    """Whether call() (launches returning a tuple of tensors) gives the
    same bits twice (no float atomics), and a CUDA graph that captured it,
    replayed once refill() has put new values into its inputs, gives the
    bits of an eager call on those inputs (and not the first call's)."""
    first, again = call(), call()
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    refill()
    graph.replay()
    eager = call()
    torch.cuda.synchronize()
    ok = (all(torch.equal(x, y) for x, y in zip(first, again))
          and all(torch.equal(x, y) for x, y in zip(captured, eager))
          and not torch.equal(first[0], eager[0]))
    del graph
    return ok


def check_flash_repeat(gen: torch.Generator) -> None:
    """K1 at the prefill shape in each mode: two launches give the same
    bits (no float atomics), and a CUDA graph that captured the launch
    replays it on new inputs, bit for bit as an eager launch on them."""
    b, s, h = 4, 623, 32

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    seg = lengths_to_seg(PROMPT_LENS, s, "cuda")
    for modes in ({}, {"alibi": True}, {"sliding_window": 256}):
        q, k, v = r(b, s, h, 128), r(b, s, h, 128), r(b, s, h, 128)

        def refill():
            for t in (q, k, v):
                t.copy_(r(*t.shape))

        ok = repeats_and_replays(
            lambda: flash_attention_fwd(q, k, v, seg, seg, **modes), refill)
        print(f"flash_fwd {modes or 'base mode'} B={b} S={s}: bitwise repeat "
              f"and CUDA-graph replay on new inputs {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_fwd is not bitwise repeatable or "
                                 "does not replay from a CUDA graph")


def check_flash_bwd_repeat(gen: torch.Generator) -> None:
    """K2 and K3 at the train shape in each mode: two launches give the same
    bits (no float atomics; K3's GQA sum stays in the block), and a CUDA
    graph that captured both launches replays them on new inputs (new q, k,
    v, dO and the o, LSE and delta of K1 on them), bit for bit as eager
    launches on those inputs."""
    b, s, h, kvh = 4, TRAIN_SPLICED, 32, 8
    lens = (s, s - 7, s - 64, s - 301)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    seg = lengths_to_seg(lens, s, "cuda")
    for modes in ({}, {"alibi": True}, {"sliding_window": 256}):
        q, k, v, do = r(b, s, h, 128), r(b, s, kvh, 128), r(
            b, s, kvh, 128), r(b, s, h, 128)
        do[seg == 0] = 0
        o, lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
        delta = flash_attention_delta(o, do)
        args = (q, k, v, seg, seg, do, lse, delta)

        def both():
            return (flash_attention_bwd_dq(*args, **modes),
                    *flash_attention_bwd_dkv(*args, **modes))

        def refill():
            for t in (q, k, v, do):
                t.copy_(r(*t.shape))
            do[seg == 0] = 0
            o, new_lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
            lse.copy_(new_lse)
            delta.copy_(flash_attention_delta(o, do))

        ok = repeats_and_replays(both, refill)
        print(f"flash_bwd {modes or 'base mode'} B={b} S={s} H={h} "
              f"KVH={kvh}: bitwise repeat and CUDA-graph replay on new "
              f"inputs {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_bwd is not bitwise repeatable or "
                                 "does not replay from a CUDA graph")


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
            limit = BWD_RTOL * (w.abs().max() + w.abs())
            ok = ok and bool((g - w).abs().le(limit).all()) and (
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
            # the yardstick: autograd's backward of one SDPA call under the
            # same mask (dq, dk and dv together), CUDA events around it
            mask = ((seg[:, :, None] == seg[:, None, :])
                    & (seg[:, :, None] != 0)
                    & torch.ones(s, s, dtype=torch.bool, device=dev).tril())
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves,
                                                 attn_mask=mask[:, None])
            dot = do.transpose(1, 2)
            timing["library"] = timed_ms(lambda: torch.autograd.grad(
                out, leaves, dot, retain_graph=True))
            del mask, leaves, out, dot
            io = tensor_bytes(q, k, v, seg, do, lse, delta)
            timing["dq_bound"] = bound(io + tensor_bytes(q),
                                       3 * 2 * d * pairs)
            timing["dkv_bound"] = bound(io + tensor_bytes(k, v),
                                        4 * 2 * d * pairs)
            # 2 * D FLOP per live (query, key) pair for each product: K2
            # computes S, dP and dQ, K3 S, dP, dV and dK
            print(f"flash_bwd time: K2 (dq) {timing['dq']:.4f} ms, "
                  f"{3 * 2 * d * pairs / timing['dq'] / 1e9:.1f} TFLOP/s; "
                  f"K3 (dk, dv) {timing['dkv']:.4f} ms, "
                  f"{4 * 2 * d * pairs / timing['dkv'] / 1e9:.1f} TFLOP/s; "
                  f"plain backward (dq, dk, dv together) "
                  f"{timing['plain']:.4f} ms, SDPA backward (all three) "
                  f"{timing['library']:.4f} ms; bounds "
                  f"{timing['dq_bound']['bound_ms']:.4f} and "
                  f"{timing['dkv_bound']['bound_ms']:.4f} ms by "
                  f"{timing['dq_bound']['bound_by']}; on live causal pairs; "
                  f"{bwd_plan(b, s, s, h, kvh)}")
        del q, k, v, do, o, lse, delta, got, want
    # library_ms: the one SDPA backward computes what K2 and K3 compute
    # together
    common = {"route": "cuda", "source": "halva_tpu_torch/csrc/flash_bwd.cu",
              "plain_ms": timing["plain"], "library_ms": timing["library"]}
    return [
        {"name": "flash_bwd_dq", "replaces":
         "halva_tpu/ops/flash_attention.py:206", "max_abs_err": worst["dq"],
         "ms": timing["dq"], **timing["dq_bound"], **common},
        {"name": "flash_bwd_dkv", "replaces":
         "halva_tpu/ops/flash_attention.py:279", "max_abs_err": worst["dkv"],
         "ms": timing["dkv"], **timing["dkv_bound"], **common},
    ]


FLASH_SOURCES = {
    "flash_fwd": ("halva_tpu_torch/csrc/flash_fwd.cu",
                  "halva_tpu/ops/flash_attention.py:83"),
    "flash_bwd_dq": ("halva_tpu_torch/csrc/flash_bwd.cu",
                     "halva_tpu/ops/flash_attention.py:206"),
    "flash_bwd_dkv": ("halva_tpu_torch/csrc/flash_bwd.cu",
                      "halva_tpu/ops/flash_attention.py:279"),
}


def _sdpa_mask(mask, bias):
    """The additive bf16 mask one SDPA call takes for a bool mask and an
    ALiBi bias (the yardstick only)."""
    if bias is None:
        return mask
    return bias.masked_fill(~mask, float("-inf")).bfloat16()


def flash_mode_case(gen, label, b, s, h, kvh, lens, modes, packed_at=None,
                    shard=None, timed=False):
    """K1, K2 and K3 in one mode against their plain versions on random bf16
    inputs of B rows of S tokens (padded to `lens`, two documents per row
    from `packed_at` on). `shard` = (offset, rows): only that shard of the
    queries runs, with q_offset, against all keys, and is also held against
    the same rows of the full call. Returns {"fwd": .., "dq": .., "dkv": ..}
    of max_abs_err and, when timed, ms, plain_ms, library_ms and the bound
    on this run's live pairs."""
    dev, d = "cuda", 128

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q, k, v, do = r(b, s, h, d), r(b, s, kvh, d), r(b, s, kvh, d), r(
        b, s, h, d)
    seg = lengths_to_seg(lens, s, dev)
    if packed_at is not None:
        seg = seg * (1 + (torch.arange(s, device=dev) >= packed_at).int())
    kw = dict(modes)
    qseg = seg
    full = None
    if shard is not None:
        off, n = shard
        full_o, full_lse = flash_attention_fwd(q, k, v, seg, seg, **modes)
        do_full = torch.zeros_like(do)
        do_full[:, off:off + n] = do[:, off:off + n]
        do_full[seg == 0] = 0
        full = (full_o[:, off:off + n],
                *flash_attention_bwd(q, k, v, seg, seg, full_o, full_lse,
                                     do_full, **modes))
        full = (full[0], full[1][:, off:off + n], full[2], full[3])
        q, do, qseg = (t[:, off:off + n].contiguous() for t in (q, do, seg))
        kw["q_offset"] = off
    live_q, live_k = qseg != 0, seg != 0
    do[~live_q] = 0  # dead rows never reach a loss
    o, lse = flash_attention_fwd(q, k, v, qseg, seg, **kw)
    delta = flash_attention_delta(o, do)
    args = (q, k, v, qseg, seg, do, lse, delta)
    got = (o, flash_attention_bwd_dq(*args, **kw),
           *flash_attention_bwd_dkv(*args, **kw))
    want = (flash_attention_plain(q, k, v, qseg, seg, **kw),
            *flash_attention_bwd_plain(q, k, v, qseg, seg, o, lse, do, **kw))
    torch.cuda.synchronize()
    lives = (live_q, live_q, live_k, live_k)
    errs, line, ok = {}, [], True
    for name, g, w, lv in zip(("o", "dq", "dk", "dv"), got, want, lives):
        g, w = g[lv].float(), w[lv].float()
        err, rel = max_abs(g, w), rel_err(g, w)
        if name == "o":
            good = within(g, w)
        else:
            limit = BWD_RTOL * (w.abs().max() + w.abs())
            good = bool((g - w).abs().le(limit).all()) and rel <= BWD_REL
        ok = ok and good and bool(torch.isfinite(g).all())
        errs[name] = err
        line.append(f"{name} {err:.3e} rel {rel:.3e}")
    if full is not None:
        # kernel against kernel: the shard equals the full call's rows
        for name, g, w, lv in zip(("o", "dq", "dk", "dv"), got, full, lives):
            g, w = g[lv].float(), w[lv].float()
            scale = 1.0 if name == "o" else float(w.abs().max())
            same = bool((g - w).abs().le(
                KERNEL_ATOL * scale + BWD_RTOL * w.abs()).all())
            ok = ok and same
            line.append(f"{name} vs the full call's rows "
                        f"{max_abs(g, w):.3e}")
    mask = make_attention_mask(qseg, seg, True, q_offset=kw.get("q_offset"),
                               sliding_window=kw.get("sliding_window"))
    pairs = h * int(mask.sum())
    print(f"flash modes {label} B={b} Sq={q.shape[1]} Skv={s} H={h} "
          f"KVH={kvh} {kw}: max_abs_err " + ", ".join(line)
          + f"; {pairs / 1e6:.1f} M live pairs (limits o {KERNEL_ATOL} + "
          f"{KERNEL_RTOL}*|plain|, grads {BWD_RTOL}*(max|plain| + |plain|), "
          f"rel {BWD_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernels in mode {label} disagree with "
                             "their plain versions")
    out = {"fwd": {"max_abs_err": errs["o"]},
           "dq": {"max_abs_err": errs["dq"]},
           "dkv": {"max_abs_err": max(errs["dk"], errs["dv"])}}
    if not timed:
        return out
    ms = {"fwd": device_ms(lambda: flash_attention_fwd(q, k, v, qseg, seg,
                                                       **kw)),
          "dq": device_ms(lambda: flash_attention_bwd_dq(*args, **kw)),
          "dkv": device_ms(lambda: flash_attention_bwd_dkv(*args, **kw))}
    plain_fwd = device_ms(lambda: flash_attention_plain(q, k, v, qseg, seg,
                                                        **kw), iters=5)
    plain_bwd = device_ms(lambda: flash_attention_bwd_plain(
        q, k, v, qseg, seg, o, lse, do, **kw), iters=5)
    # the yardstick: one SDPA call (GQA heads repeated outside the timed
    # call) under the same mask, the ALiBi bias folded into it; its
    # autograd backward for K2 and K3 together
    bias = None
    if kw.get("alibi"):
        bias = causal_alibi_bias(h, q.shape[1], s, dev,
                                 kw.get("q_offset") or 0)
    amask = _sdpa_mask(mask, bias)
    del bias
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in
              (q, k.repeat_interleave(h // kvh, dim=2),
               v.repeat_interleave(h // kvh, dim=2))]
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        *[t.detach() for t in leaves], attn_mask=amask))
    sd = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
    dot = do.transpose(1, 2)
    lib_bwd = timed_ms(lambda: torch.autograd.grad(sd, leaves, dot,
                                                   retain_graph=True),
                       iters=10)
    del sd, leaves, amask, mask
    io = tensor_bytes(q, k, v, qseg, seg)
    bounds = {
        "fwd": bound(io + tensor_bytes(o, lse), 2 * 2 * d * pairs),
        "dq": bound(io + tensor_bytes(do, lse, delta, q), 3 * 2 * d * pairs),
        "dkv": bound(io + tensor_bytes(do, lse, delta, k, v),
                     4 * 2 * d * pairs)}
    flop = {"fwd": 4, "dq": 6, "dkv": 8}
    print(f"flash modes {label} time ({k1_plan(b, q.shape[1], s, h)}; "
          f"{bwd_plan(b, q.shape[1], s, h, kvh)}): "
          + "; ".join(
              f"{name} {ms[name]:.4f} ms "
              f"({flop[name] * d * pairs / ms[name] / 1e9:.1f} TFLOP/s live, "
              f"bound {bounds[name]['bound_ms']:.4f} by "
              f"{bounds[name]['bound_by']})" for name in ("fwd", "dq", "dkv"))
          + f"; plain forward {plain_fwd:.4f} ms, plain backward (dq, dk, dv "
          f"together) {plain_bwd:.4f} ms; SDPA with the mask"
          f"{' and bias' if kw.get('alibi') else ''} {lib_fwd:.4f} ms, its "
          f"backward (all three) {lib_bwd:.4f} ms")
    if modes:
        # the base mode on the same inputs (its own o, LSE and delta): what
        # the mode costs or saves against plain causal attention
        bkw = {"q_offset": kw["q_offset"]} if "q_offset" in kw else {}
        bo, blse = flash_attention_fwd(q, k, v, qseg, seg, **bkw)
        bargs = (q, k, v, qseg, seg, do, blse, flash_attention_delta(bo, do))
        base = (device_ms(lambda: flash_attention_fwd(q, k, v, qseg, seg,
                                                      **bkw)),
                device_ms(lambda: flash_attention_bwd_dq(*bargs, **bkw)),
                device_ms(lambda: flash_attention_bwd_dkv(*bargs, **bkw)))
        print(f"flash modes {label}: the base mode on the same inputs takes "
              f"fwd {base[0]:.4f}, dq {base[1]:.4f}, dkv {base[2]:.4f} ms")
    for name in out:
        out[name].update(
            ms=ms[name], plain_ms=plain_fwd if name == "fwd" else plain_bwd,
            library_ms=lib_fwd if name == "fwd" else lib_bwd, **bounds[name])
    return out


def check_flash_modes(gen: torch.Generator, base: dict) -> list:
    """K1, K2 and K3 in their ALiBi and sliding-window modes and with a
    q_offset against flash_attention_plain / flash_attention_bwd_plain: at
    the train shape (B=4 rows of 1087 tokens, padded; H=32), with a window
    of 256 that bites and skips tiles, with GQA and packed segments, at one
    row of 4,608 tokens with Mistral's heads and window (4096), and on the
    upper half of the queries against all keys. One row of the `kernels`
    line per kernel and mode, timed at B=4, S=1087, H=KVH=32. q_offset is an
    argument of every mode and has no row of its own (no main path passes
    it before context parallelism over several cards): its cases' errors go
    into the row of the mode they ran in, the base mode's into `base`, the
    rows of flash_fwd, flash_bwd_dq and flash_bwd_dkv by kernel name."""
    s = TRAIN_SPLICED
    lens = (s, s - 7, s - 64, s - 301)
    half = s // 2
    timed = {
        "alibi": flash_mode_case(gen, "alibi", 4, s, 32, 32, lens,
                                 {"alibi": True}, timed=True),
        "window": flash_mode_case(gen, "window", 4, s, 32, 32, lens,
                                  {"sliding_window": 256}, timed=True),
    }
    extra = {
        "alibi": [flash_mode_case(gen, "alibi GQA packed", 4, s, 32, 8, lens,
                                  {"alibi": True}, packed_at=500)],
        "window": [
            flash_mode_case(gen, "window GQA packed", 4, s, 32, 8, lens,
                            {"sliding_window": 256}, packed_at=500),
            flash_mode_case(gen, "window narrower than a tile", 2, s, 32, 8,
                            lens[:2], {"sliding_window": 40}),
            flash_mode_case(gen, "window, the long Mistral row", 1, LONG_ROW,
                            32, 8, (LONG_ROW,),
                            {"sliding_window": MISTRAL_7B.sliding_window},
                            timed=True),
            flash_mode_case(gen, "q_offset + window, GQA", 4, s, 32, 8, lens,
                            {"sliding_window": 256}, shard=(half, s - half))],
        "": [flash_mode_case(gen, "q_offset (upper half)", 4, s, 32, 32, lens,
                             {}, shard=(half, s - half), timed=True)],
    }
    extra["alibi"].append(
        flash_mode_case(gen, "q_offset + alibi", 2, s, 32, 32, lens[:2],
                        {"alibi": True}, shard=(300, 400)))
    torch.cuda.empty_cache()
    # the reference's dispatch for a head count the slope formula does not
    # cover: plain attention with alibi_bias, on the card too, no launch
    q = torch.randn(1, 200, 12, 128, generator=gen, device="cuda").bfloat16()
    seg = torch.ones(1, 200, dtype=torch.int32, device="cuda")
    before = sum(_kernels.launches.values())
    got = attention(q, q, q, seg, seg, alibi=True)
    want = attention(q, q, q, seg, seg, alibi=True, impl="plain")
    ok = (sum(_kernels.launches.values()) == before
          and torch.equal(got, want) and not alibi_in_kernel(12)
          and alibi_in_kernel(MPT_7B.num_heads))
    print("route: ALiBi with 12 heads (not a power of two) takes the plain "
          "attention with alibi_bias, 0 launches; MPT-7B's 32 heads take K1's"
          " ALiBi mode: the reference's dispatch by head count, "
          f"halva_tpu/ops/attention.py:152 and ops/flash_attention.py:641 "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("non-power-of-two ALiBi did not take the plain "
                             "attention")
    out = []
    for part, kernel in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"),
                         ("dkv", "flash_bwd_dkv")):
        base[kernel]["max_abs_err"] = max(
            [base[kernel]["max_abs_err"]]
            + [e[part]["max_abs_err"] for e in extra[""]])
        for mode in ("alibi", "window"):
            row = dict(timed[mode][part])
            row["max_abs_err"] = max(
                [row["max_abs_err"]]
                + [e[part]["max_abs_err"] for e in extra[mode]])
            source, replaces = FLASH_SOURCES[kernel]
            out.append({"name": f"{kernel}_{mode}", "route": "cuda",
                        "source": source, "replaces": replaces, **row})
    return out


def k4_plan(rows: int, kvh: int, sp: int, sg: int) -> str:
    """K4's launch plan at these shapes on this card, as the wrapper makes
    it (ops/decode_attention.decode_plan)."""
    splits, tps = decode_plan(rows, kvh, sp, sg,
                              sm_count(torch.device("cuda")))
    return f"splits {splits}, {tps} prompt tiles each"


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
        live_keys = sum(PROMPT_LENS) + int((steps + 1).sum())
        read = live_keys * row
        # the yardstick: one SDPA call over the concatenated prompt + gen
        # keys (concatenated outside the timed call) under a mask
        kcat = torch.cat([kp, kg], dim=3)
        vcat = torch.cat([vp, vg], dim=3)
        mask = torch.cat([seg != 0, gen_valid], dim=1)[:, None, None, :]
        qt = q.transpose(1, 2)

        def walk_sdpa():
            for li in range(layers):
                F.scaled_dot_product_attention(qt, kcat[li], vcat[li],
                                               attn_mask=mask)

        lib_ms = device_ms(walk_sdpa) / layers
        del kcat, vcat
        lim = bound(read + 2 * tensor_bytes(q) + tensor_bytes(seg, gen_valid),
                    4 * d * h * live_keys)
        print(f"decode_attn time ({k4_plan(b, kvh, sp, sg)}): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms,"
              f" SDPA over concatenated keys {lib_ms:.4f} ms, bound "
              f"{lim['bound_ms']:.4f} ms by {lim['bound_by']};"
              f" cache bytes {nominal / 1e6:.1f} MB allocated, "
              f"{read / 1e6:.1f} MB live -> {read / ms / 1e6:.0f} GB/s live")
        timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **lim}
    return {"name": "decode_attn", "route": "cuda",
            "source": "halva_tpu_torch/csrc/decode_attn.cu",
            "replaces": "halva_tpu/ops/decode_attention.py:82",
            "max_abs_err": worst, **timing}


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
            live_keys = sum(PROMPT_LENS) + int((steps + 1).sum())
            lim = bound(
                read + 2 * tensor_bytes(q) + tensor_bytes(seg, gen_valid),
                4 * d * h * live_keys)
            print(f"{name} time ({k4_plan(b, kvh, sp, sg)}): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms,"
                  f" bound {lim['bound_ms']:.4f} ms by {lim['bound_by']} (no "
                  f"library call takes these caches); {read / 1e6:.2f} MB "
                  f"live -> {read / ms / 1e6:.0f} GB/s live")
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      **lim}
        out.append({"name": name, "route": "cuda",
                    "source": "halva_tpu_torch/csrc/decode_attn.cu",
                    "replaces": "halva_tpu/ops/decode_attention.py:82",
                    "max_abs_err": worst, **timing})
    return out


def _k4_inputs(gen, mode, layers, b, kvh, sp, sg, d=128, h=32):
    """q (b, 1, h, d) and `layers` stacked prompt / gen caches of one K4
    mode (bf16 | kv8 | kv4)."""
    dev = "cuda"
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    if mode != "bf16":
        return (q, *_quant_caches(gen, mode, layers, b, kvh, sp, sg, d))

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    return (q, {"k": r(layers, b, kvh, sp, d), "v": r(layers, b, kvh, sp, d)},
            {"k": r(layers, b, kvh, sg, d), "v": r(layers, b, kvh, sg, d)})


def check_decode_b80(gen: torch.Generator) -> None:
    """K4 int4/int8 at the reference's serving batch (`bench.py`: 80 rows,
    the four prompts 20 times, H=KVH=32, Sp=623, Sg=128, random gen steps):
    against its plain version on one layer, timed over two layers (a
    layer's caches, 288 MB, outgrow the 50 MB L2), with its plan. Printed
    only: the `kernels` line keeps the B=4 rows."""
    b, kvh, sp, sg, d, layers = 80, 32, 623, 128, 128, 2
    seg = lengths_to_seg(PROMPT_LENS * (b // len(PROMPT_LENS)), sp, "cuda")
    steps = torch.randint(0, sg, (b,), generator=gen, device="cuda")
    gen_valid = torch.arange(sg, device="cuda")[None, :] <= steps[:, None]
    q, pc, gc = _k4_inputs(gen, "kv4", layers, b, kvh, sp, sg, d)

    def call(fn, li):
        return fn(q, {k: v[li] for k, v in pc.items()}, seg,
                  {k: v[li] for k, v in gc.items()}, gen_valid)

    got, want = call(decode_attend_layer, 0), call(decode_attend_plain, 0)
    torch.cuda.synchronize()
    ok = within(got, want) and bool(torch.isfinite(got).all())
    print(f"decode_attn_kv4 B={b} H={kvh} KVH={kvh} Sp={sp} Sg={sg} D={d}: "
          f"max_abs_err {max_abs(got, want):.3e} rel {rel_err(got, want):.3e}"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode_attn_kv4 at batch 80 disagrees with its "
                             "plain version")
    del got, want
    ms = device_ms(lambda: [call(decode_attend_layer, li)
                            for li in range(layers)]) / layers
    plain_ms = device_ms(lambda: [call(decode_attend_plain, li)
                                  for li in range(layers)]) / layers
    live_keys = b // len(PROMPT_LENS) * sum(PROMPT_LENS)
    live_gen = int((steps + 1).sum())
    read = (live_keys * _cache_row_bytes("kv4", kvh, d, True)
            + live_gen * _cache_row_bytes("kv4", kvh, d, False))
    lim = bound(read + 2 * tensor_bytes(q) + tensor_bytes(seg, gen_valid),
                4 * d * kvh * (live_keys + live_gen))
    print(f"decode_attn_kv4 time at batch {b} ({k4_plan(b, kvh, sp, sg)}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{lim['bound_ms']:.4f} ms by {lim['bound_by']}; {read / 1e6:.1f} "
          f"MB live -> {read / ms / 1e6:.0f} GB/s")


def decode_plan_sweep(gen: torch.Generator) -> None:
    """K4's time under forced plans at the B=4 decode shape of check_decode
    (and 4 beams an item), every mode: what the plan's aim trades. Printed
    only."""
    b, kvh, sp, sg, layers = 4, 32, 623, 128, 8
    seg = lengths_to_seg(PROMPT_LENS, sp, "cuda")
    for mode in ("bf16", "kv8", "kv4"):
        for beam_k in (1, BEAMS):
            rows = b * beam_k
            steps = torch.tensor([0, 37, 100, 127] * beam_k, device="cuda")
            gen_valid = (torch.arange(sg, device="cuda")[None, :]
                         <= steps[:, None])
            q = torch.randn(rows, 1, kvh, 128, generator=gen,
                            device="cuda").bfloat16()
            _, pc, _ = _k4_inputs(gen, mode, layers, b, kvh, sp, sg)
            _, _, gc = _k4_inputs(gen, mode, layers, rows, kvh, 2, sg)
            times = []
            for forced in (1, 2, 3, 4, 5, 6, 8, 11):
                plan = decode_plan(rows, kvh, sp, sg, 0, forced)
                ms = device_ms(lambda: [decode_attend_layer(
                    q, {k: v[li] for k, v in pc.items()}, seg,
                    {k: v[li] for k, v in gc.items()}, gen_valid,
                    beam_k=beam_k, beam_route="grid", splits=forced)
                    for li in range(layers)]) / layers
                times.append(f"{plan[0]}: {ms:.4f}")
            print(f"decode_attn {mode} rows={rows} (beam_k {beam_k}) ms by "
                  f"splits: {', '.join(times)}; planned "
                  f"{k4_plan(rows, kvh, sp, sg)}")
            del pc, gc


def decode_checks(gen: torch.Generator) -> list:
    """K4 in every mode at B=4, then at batch 80 and under forced plans:
    its rows of the `kernels` line."""
    rows = [check_decode(gen), *check_decode_quant(gen),
            *check_fold(gen, with_k5=False)]
    check_decode_b80(gen)
    decode_plan_sweep(gen)
    return rows


FOLD_SOURCE = "halva_tpu_torch/csrc/fold_attn.cu"
FOLD_REPLACES = "halva_tpu/ops/decode_attention.py:306"


def _fold_caches(gen, mode, layers, b, gen_rows, kvh, sp, sg, d):
    """Stacked prompt caches at b rows and gen caches at gen_rows rows in
    cache mode `mode` (bf16 | kv8 | kv4)."""
    dev = "cuda"
    if mode != "bf16":
        pc, _ = _quant_caches(gen, mode, layers, b, kvh, sp, sg, d)
        _, gc = _quant_caches(gen, "kv8", layers, gen_rows, kvh, 2, sg, d)
        return pc, gc

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    return ({"k": r(layers, b, kvh, sp, d), "v": r(layers, b, kvh, sp, d)},
            {"k": r(layers, gen_rows, kvh, sg, d),
             "v": r(layers, gen_rows, kvh, sg, d)})


def _cache_row_bytes(mode, kvh, d, prompt):
    """k + v (+ scales) bytes of one live cache position, all heads."""
    if mode == "bf16":
        return kvh * d * 2 * 2
    return kvh * (d if (mode == "kv4" and prompt) else 2 * d) + 4 * kvh


FOLD_FORCED = (1, 2, 3, 5)  # forced aims of K5's plan, beside the SM count's


def k5_plan(items, kvh, rows, group, sp, sg, shared, splits=None) -> str:
    """K5's launch plan at these shapes on this card, as the wrapper makes
    it (ops/decode_attention.fold_plan)."""
    p = fold_plan(items, kvh, rows, group, sp, sg,
                  sm_count(torch.device("cuda")), shared, splits)
    return (f"{p.splits} splits: {p.psplits} of {p.tps} prompt tiles + "
            f"{p.gsplits} gen, {p.chunks} chunk(s)")


def check_fold(gen: torch.Generator, with_k5: bool = True) -> list:
    """K5 against fold_attend_plain, and K4's beam mode against
    decode_attend_plain(beam_k=4), at the 7B shapes of the beam and verify
    steps: B=4 items, H=32, Sp=623 (odd), D=128. Per-beam gen stage at K=4,
    Sg=128 in the three cache modes, MHA and GQA (KVH=8: Mistral's 16 rows
    an item); shared gen stage with candidates at K=4 (Sg=128), K=8
    (Sg=256) and GQA. Each K5 shape also under forced plans of 1, 2, 3 and
    5 splits, against fold_attend_split_plain under that plan and against
    fold_attend_plain, timed. One row of the `kernels` line per cache mode
    and stage; the times are the K=4 MHA ones. Then the two beam routes
    against each other at B=4 and B=80 items in every mode, and the route
    `beam_route="auto"` takes at each, printed only. With `with_k5` False,
    only K4's beam mode: its checks, times and rows."""
    dev = "cuda"
    b, h, sp, d, layers = 4, 32, 623, 128, 4
    seg = lengths_to_seg(PROMPT_LENS, sp, dev)
    names = {"bf16": "", "kv8": "_kv8", "kv4": "_kv4"}
    out = []

    def compare(label, got, want):
        torch.cuda.synchronize()
        ok = within(got, want) and bool(torch.isfinite(got).all())
        err, rel = max_abs(got, want), rel_err(got, want)
        print(f"{label}: max_abs_err {err:.3e} rel {rel:.3e} (limits "
              f"{KERNEL_ATOL} + {KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version")
        return err

    def layer(t, li):
        return {key: v[li] for key, v in t.items()}

    def forced_plans(label, call, split_plain, kvh, rows, sp_, sg_, shared):
        """K5 under each forced plan: against its split plain version on
        layer 0, bit-stable across two calls, and timed over the layers.
        call(li, splits) runs the kernel, split_plain(li, plan) the plain
        split. Returns the worst error and prints the times."""
        worst, times = 0.0, []
        for forced in FOLD_FORCED:
            plan = fold_plan(b, kvh, rows, h // kvh, sp_, sg_,
                             sm_count(torch.device(dev)), shared, forced)
            got = call(0, forced)
            worst = max(worst, compare(
                f"{label} forced {forced} ({plan.splits} splits) vs split "
                "plain", got, split_plain(0, plan)))
            if not torch.equal(got, call(0, forced)):
                raise AssertionError(f"{label}: two calls differ")
            ms = device_ms(lambda: [call(li, forced)
                                    for li in range(layers)]) / layers
            times.append(f"{plan.splits}: {ms:.4f}")
        print(f"{label} ms by splits (forced aims {FOLD_FORCED}): "
              f"{', '.join(times)}; planned "
              f"{k5_plan(b, kvh, rows, h // kvh, sp_, sg_, shared)}")
        return worst

    # ---- per-beam gen stage (beam search), and K4's beam mode beside it
    k, sg = BEAMS, 128
    steps = torch.randint(0, sg, (b * k,), generator=gen, device=dev)
    steps[0] = 0  # a single valid gen slot
    gen_valid = torch.arange(sg, device=dev)[None, :] <= steps[:, None]
    live_prompt = sum(PROMPT_LENS)
    live_gen = int((steps + 1).sum())
    for mode in ("bf16", "kv8", "kv4"):
        worst = {"fold": 0.0, "grid": 0.0}
        for kvh in (32, 8):
            q = torch.randn(b, k, h, d, generator=gen, device=dev).bfloat16()
            q1 = q.reshape(b * k, 1, h, d)
            pc, gc = _fold_caches(gen, mode, layers, b, b * k, kvh, sp, sg, d)

            def fold(fn, li, **kw):
                return fn(q, layer(pc, li), seg, layer(gc, li), gen_valid,
                          fold_k=k, **kw)

            def grid(li):
                return decode_attend_layer(q1, layer(pc, li), seg,
                                           layer(gc, li), gen_valid,
                                           beam_k=k, beam_route="grid")

            tag = f"B={b} K={k} H={h} KVH={kvh} Sp={sp} Sg={sg} D={d}"
            for li in (0, layers - 1):
                if with_k5:
                    worst["fold"] = max(worst["fold"], compare(
                        f"fold_attn{names[mode]} {tag}",
                        fold(fold_attend_layer, li),
                        fold(fold_attend_plain, li)))
                want1 = decode_attend_plain(
                    q1, layer(pc, li), seg, layer(gc, li), gen_valid,
                    beam_k=k)
                worst["grid"] = max(worst["grid"], compare(
                    f"decode_attn{names[mode]}_beam {tag}", grid(li), want1))
            rows = k * h // kvh
            if with_k5:
                worst["fold"] = max(worst["fold"], forced_plans(
                    f"fold_attn{names[mode]} {tag}",
                    lambda li, z: fold(fold_attend_layer, li, splits=z),
                    lambda li, plan: fold(fold_attend_split_plain, li,
                                          plan=plan),
                    kvh, rows, sp, sg, False))

            def walk(fn):
                for li in range(layers):
                    fn(li)

            if with_k5:
                ms = device_ms(lambda: walk(
                    lambda li: fold(fold_attend_layer, li))) / layers
                plain_ms = device_ms(lambda: walk(
                    lambda li: fold(fold_attend_plain, li))) / layers
            grid_ms = device_ms(lambda: walk(grid)) / layers
            grid_plain_ms = device_ms(lambda: walk(
                lambda li: decode_attend_plain(
                    q1, layer(pc, li), seg, layer(gc, li), gen_valid,
                    beam_k=k))) / layers
            # every query row meets every live key of its item and beam
            flops = 4 * d * h * (k * live_prompt + live_gen)
            small = 2 * tensor_bytes(q) + tensor_bytes(seg, gen_valid)
            gen_bytes = live_gen * _cache_row_bytes(mode, kvh, d, False)
            prompt_bytes = live_prompt * _cache_row_bytes(mode, kvh, d, True)
            # K5 must read the prompt once per item; the function K4's beam
            # mode computes is the same, so its bound is the same
            lim = bound(prompt_bytes + gen_bytes + small, flops)
            lib_ms = None
            if mode == "bf16" and kvh == h:
                # the yardstick: one SDPA call at B*K rows over [prompt of
                # the row's item | the row's gen cache] keys, repeated and
                # concatenated outside the timed call (so it reads the
                # prompt once per beam)
                kcat = torch.cat([pc["k"].repeat_interleave(k, dim=1),
                                  gc["k"]], dim=3)
                vcat = torch.cat([pc["v"].repeat_interleave(k, dim=1),
                                  gc["v"]], dim=3)
                mask = torch.cat([(seg != 0).repeat_interleave(k, dim=0),
                                  gen_valid], dim=1)[:, None, None, :]
                qt = q1.transpose(1, 2)

                def walk_sdpa():
                    for li in range(layers):
                        F.scaled_dot_product_attention(
                            qt, kcat[li], vcat[li], attn_mask=mask)

                got = F.scaled_dot_product_attention(
                    qt, kcat[0], vcat[0], attn_mask=mask).transpose(1, 2)
                compare(f"SDPA yardstick of fold_attn {tag}",
                        got.reshape(b, k, h, d), fold(fold_attend_plain, 0))
                lib_ms = device_ms(walk_sdpa) / layers
                del kcat, vcat
            lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            k5 = (f"K5 {ms:.4f} ms (plain {plain_ms:.4f}; "
                  f"{k5_plan(b, kvh, rows, h // kvh, sp, sg, False)}), "
                  if with_k5 else "")
            print(f"fold_attn{names[mode]} {tag} time: {k5}K4 beam route "
                  f"{grid_ms:.4f} ms (plain {grid_plain_ms:.4f}; "
                  f"{k4_plan(b * k, kvh, sp, sg)}), bound "
                  f"{lim['bound_ms']:.4f} ms by {lim['bound_by']}; "
                  f"{(prompt_bytes + gen_bytes) / 1e6:.2f} MB live caches; "
                  f"SDPA at B*K rows over repeated prompt keys {lib}")
            if kvh == h:
                if with_k5:
                    fold_t = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, **lim}
                grid_t = {"ms": grid_ms, "plain_ms": grid_plain_ms,
                          "library_ms": lib_ms, **lim}
            del pc, gc
        if with_k5:
            out.append({"name": "fold_attn" + names[mode], "route": "cuda",
                        "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
                        "max_abs_err": worst["fold"], **fold_t})
        out.append({"name": f"decode_attn{names[mode]}_beam", "route": "cuda",
                    "source": "halva_tpu_torch/csrc/decode_attn.cu",
                    "replaces": "halva_tpu/ops/decode_attention.py:82",
                    "max_abs_err": worst["grid"], **grid_t})

    if not with_k5:
        return out

    # ---- the two beam routes at B=4 (above) and where a layer's prompt
    # cache outgrows the L2: batch 80 (the reference's serving batch), in
    # every mode, times only, not in the `kernels` line; and the route
    # beam_route="auto" takes at each
    b80, k, sg, layers80 = 80, BEAMS, 128, 2
    seg80 = lengths_to_seg(PROMPT_LENS * (b80 // len(PROMPT_LENS)), sp, dev)
    steps = torch.randint(0, sg, (b80 * k,), generator=gen, device=dev)
    gen_valid = torch.arange(sg, device=dev)[None, :] <= steps[:, None]
    for mode in ("bf16", "kv8", "kv4"):
        q = torch.randn(b80, k, h, d, generator=gen, device=dev).bfloat16()
        q1 = q.reshape(b80 * k, 1, h, d)
        pc, gc = _fold_caches(gen, mode, layers80, b80, b80 * k, h, sp, sg, d)

        def fold(li):
            return fold_attend_layer(q, layer(pc, li), seg80, layer(gc, li),
                                     gen_valid, fold_k=k)

        def grid(li):
            return decode_attend_layer(q1, layer(pc, li), seg80,
                                       layer(gc, li), gen_valid, beam_k=k,
                                       beam_route="grid")

        want = fold_attend_plain(q, layer(pc, 0), seg80, layer(gc, 0),
                                 gen_valid, fold_k=k)
        tag = f"B={b80} K={k} H={h} KVH={h} Sp={sp} Sg={sg} D={d}"
        compare(f"fold_attn{names[mode]} {tag}", fold(0), want)
        compare(f"decode_attn{names[mode]}_beam {tag}",
                grid(0).reshape(want.shape), want)
        del want
        ms = device_ms(lambda: [fold(li) for li in range(layers80)])
        grid_ms = device_ms(lambda: [grid(li) for li in range(layers80)])
        prompt_mb = (b80 // len(PROMPT_LENS) * sum(PROMPT_LENS)
                     * _cache_row_bytes(mode, h, d, True) / 1e6)
        print(f"fold_attn{names[mode]} at batch {b80} ({prompt_mb:.0f} MB of "
              f"live prompt cache per layer, L2 50 MB): K5 "
              f"{ms / layers80:.4f} ms "
              f"({k5_plan(b80, h, k, 1, sp, sg, False)}), K4 beam route "
              f"{grid_ms / layers80:.4f} ms")
        del pc, gc
    routes = []
    for items in (b, b80):
        for mode in ("bf16", "kv8", "kv4"):
            pc, _ = _fold_caches(gen, mode, 1, items, 1, h, sp, 1, d)
            routes.append(f"B={items} {mode}: " + auto_beam_route(
                layer(pc, 0), seg80[:items], k))
            del pc
    print("route: beam_route='auto' (ops/decode_attention.auto_beam_route) "
          f"at K={k}, H=KVH={h}, Sp={sp}: {'; '.join(routes)}")

    # ---- shared gen stage with candidates (speculative verify)
    for mode in ("bf16", "kv8", "kv4"):
        worst = 0.0
        for k, sg, kvh in ((4, 128, 32), (8, 256, 32), (4, 128, 8)):
            q = torch.randn(b, k, h, d, generator=gen, device=dev).bfloat16()
            kc = torch.randn(b, k, kvh, d, generator=gen,
                             device=dev).bfloat16()
            vc = torch.randn(b, k, kvh, d, generator=gen,
                             device=dev).bfloat16()
            gen_len = torch.tensor([0, 37, 100, sg - k], device=dev)
            gen_valid = torch.arange(sg, device=dev)[None, :] < gen_len[:, None]
            pc, gc = _fold_caches(gen, mode, layers, b, b, kvh, sp, sg, d)

            def fold(fn, li, **kw):
                return fn(q, layer(pc, li), seg, layer(gc, li), gen_valid,
                          fold_k=k, shared_gen=True, candidates=(kc, vc), **kw)

            tag = f"B={b} K={k} H={h} KVH={kvh} Sp={sp} Sg={sg} D={d}"
            for li in (0, layers - 1):
                worst = max(worst, compare(
                    f"fold_attn{names[mode]}_shared {tag}",
                    fold(fold_attend_layer, li), fold(fold_attend_plain, li)))
            worst = max(worst, forced_plans(
                f"fold_attn{names[mode]}_shared {tag}",
                lambda li, z: fold(fold_attend_layer, li, splits=z),
                lambda li, plan: fold(fold_attend_split_plain, li, plan=plan),
                kvh, k * h // kvh, sp, sg, True))
            if kvh != h:
                continue

            def walk(fn):
                for li in range(layers):
                    fold(fn, li)

            ms = device_ms(lambda: walk(fold_attend_layer)) / layers
            plain_ms = device_ms(lambda: walk(fold_attend_plain)) / layers
            live_gen = int(gen_len.sum())
            live_prompt = sum(PROMPT_LENS)
            # query i also meets candidates j <= i: K (K + 1) / 2 per item
            flops = 4 * d * h * (k * (live_prompt + live_gen)
                                 + b * k * (k + 1) // 2)
            nbytes = (live_prompt * _cache_row_bytes(mode, kvh, d, True)
                      + live_gen * _cache_row_bytes(mode, kvh, d, False)
                      + 2 * tensor_bytes(q) + tensor_bytes(kc, vc, seg,
                                                           gen_valid))
            lim = bound(nbytes, flops)
            lib_ms = None
            if mode == "bf16":
                # the yardstick: one SDPA call over [prompt | gen |
                # candidates] keys, concatenated outside the timed call
                kcat = torch.cat([pc["k"], gc["k"], kc.transpose(1, 2)[None]
                                  .expand(layers, b, kvh, k, d)], dim=3)
                vcat = torch.cat([pc["v"], gc["v"], vc.transpose(1, 2)[None]
                                  .expand(layers, b, kvh, k, d)], dim=3)
                causal = torch.ones(k, k, dtype=torch.bool, device=dev).tril()
                mask = torch.cat([
                    (seg != 0)[:, None, :].expand(b, k, sp),
                    gen_valid[:, None, :].expand(b, k, sg),
                    causal[None].expand(b, k, k)], dim=2)[:, None]
                qt = q.transpose(1, 2)

                def walk_sdpa():
                    for li in range(layers):
                        F.scaled_dot_product_attention(
                            qt, kcat[li], vcat[li], attn_mask=mask)

                lib_ms = device_ms(walk_sdpa) / layers
                del kcat, vcat
            lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"fold_attn{names[mode]}_shared K={k} Sg={sg} time: kernel "
                  f"{ms:.4f} ms ({k5_plan(b, kvh, k, 1, sp, sg, True)}), "
                  f"plain {plain_ms:.4f} ms, SDPA over concatenated keys "
                  f"{lib}, bound {lim['bound_ms']:.4f} ms by "
                  f"{lim['bound_by']}")
            if k == BEAMS:
                timing = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, **lim}
            del pc, gc
        out.append({"name": f"fold_attn{names[mode]}_shared", "route": "cuda",
                    "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
                    "max_abs_err": worst, **timing})
    return out


# (K, N) of the 7B decode matmuls: wq/wk/wv/wo, gate/up, down
W4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))


def k6_plan_text(b: int, k: int, np_: int, groups: int) -> str:
    """K6's launch plan as the wrapper picks it (an older tree's plan takes
    no scale groups)."""
    try:
        rc, splits, ksplit = w4_matmul.plan(b, k, np_, groups)
    except TypeError:
        rc, splits, ksplit = w4_matmul.plan(b, k, np_)
    return f"plan: rows {rc}, {splits} x {ksplit} K rows"


def check_w4(gen: torch.Generator) -> dict:
    """K6 against w4_dense_stacked_plain at the 7B decode matmul shapes,
    per-channel and g=128 scales, B = 4 (the smoke's batch), 16 and 32 (the
    rows of 4 beams and of an 8-token verify step) and 80 (the reference's
    serving batch), each line with its launch plan, bound and rate; at B=4
    also against the loop's own arithmetic in torch ops
    (w4_dense_stacked_split_plain) and beside dequantize + torch.matmul. The
    JSON line carries gate/up at B=4, g=128."""
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
            for b in (4, 16, 32, 80):
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
                lim = bound(nbytes + tensor_bytes(x) + b * n * 2,
                            2 * b * k * n)
                split = ""
                if b == 4:
                    # the loop's own arithmetic: its rounding and its order
                    # of sums up to the tensor cores' within a range
                    got = call(w4_dense_stacked, 0)
                    # (an attribute: --gemm-only also runs on older trees)
                    want = call(w4_matmul.w4_dense_stacked_split_plain,
                                0).float()
                    torch.cuda.synchronize()
                    diff = (got.float() - want).abs()
                    close = bool((diff <= 2**-7 * want.abs() + 2**-10
                                  * want.abs().max()).all())
                    ok = ok and close
                    split = (f"; against its split version max_abs_err "
                             f"{float(diff.max()):.3e} (limit 2^-7 |split| "
                             f"+ 2^-10 max|split|)")
                print(f"w4_gemv B={b} K={k} N={n} G={groups} "
                      f"[{k6_plan_text(b, k, np_, groups)}]: max_abs_err "
                      f"{err:.3e} rel {rel:.3e} (limits {KERNEL_ATOL} + "
                      f"{KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}){split}; "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{lim['bound_ms']:.4f} ms by {lim['bound_by']} "
                      f"({lim['bound_ms'] / ms:.1%} of it); "
                      f"{nbytes / 1e6:.2f} MB packed weights + scales -> "
                      f"{nbytes / ms / 1e6:.0f} GB/s {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("w4_gemv disagrees with its plain "
                                         "version")
                worst = max(worst, err)
                if b == 4:
                    # no PyTorch call multiplies by packed int4 weights: the
                    # yardstick is K7's, dequantize + torch.matmul
                    lib_ms = device_ms(lambda: walk(
                        lambda x_, p: x_ @ dequantize_int4(
                            p["kernel_q4p"], p["kernel_scale4p"],
                            torch.bfloat16))) / layers
                    print(f"w4_gemv B={b} K={k} N={n} G={groups}: dequantize"
                          f" + torch.matmul {lib_ms:.4f} ms")
                if (k, n, groups, b) == (4096, 11008, 4096 // W4_GROUP, 4):
                    timing = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, **lim}
        del w
    # Mistral-7B's decode matmuls at the smoke's batch, g=128: wk/wv
    # (N=1024), gate/up (N=14336), down (K=14336); compared, not timed
    for k, n in ((4096, 1024), (4096, 14336), (14336, 4096)):
        groups = k // W4_GROUP
        p = {"kernel_q4p": torch.randint(-128, 128, (k, n // 2),
                                         generator=gen, device=dev,
                                         dtype=torch.int8),
             "kernel_scale4p": (torch.rand(2, groups, n // 2, generator=gen,
                                           device=dev) * 0.02
                                + 0.005).bfloat16()}
        x = torch.randn(4, k, generator=gen, device=dev).bfloat16()
        got, want = w4_dense_stacked(x, p), w4_dense_stacked_plain(x, p)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        ok = within(got, want) and bool(torch.isfinite(got).all())
        print(f"w4_gemv B=4 K={k} N={n} G={groups} (mistral-7b): max_abs_err "
              f"{err:.3e} rel {rel_err(got, want):.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("w4_gemv disagrees with its plain version")
        worst = max(worst, err)
    return {"name": "w4_gemv", "route": "cuda",
            "source": "halva_tpu_torch/csrc/w4_gemv.cu",
            "replaces": "halva_tpu/ops/w4_matmul.py:313",
            "max_abs_err": worst, **timing}


# K7 and K8 against their plain versions: |got - plain| <= GEMM_RTOL *
# (max|plain| / 4 + |plain|) and the relative norm of the difference <=
# GEMM_REL. Both sum bf16 products in fp32 and round the output to bf16 (2^-8
# relative); a sum over thousands of products has entries near 0, so the
# elementwise bound is relative to the output's scale. A grouped K7 also
# rounds nibble * scale to bf16 before the product, as the Pallas kernel
# does (2^-9 relative per weight, averaging out over K).
GEMM_RTOL = 1e-2
GEMM_REL = 4e-3
MISTRAL_W4_SHAPES = ((4096, 1024), (4096, 14336), (14336, 4096))
GEMM_ROWS = (9, 16, 32, 80, 2492, 4348)  # ragged; beams, verify, batch 80;
# prefill (B=4 x 623) and the train step's pos+neg forward (4 x 1087)
TRAIN_ROWS = 2 * TRAIN_SPLICED  # one forward of the micro-batch: dx's rows
TOWER_ROWS = 4 * CLIP_VIT_L_336.num_positions  # 4 images of tower tokens


def gemm_within(got: torch.Tensor, want: torch.Tensor):
    want = want.float()
    diff = (got.float() - want).abs()
    ok = bool((diff <= GEMM_RTOL * (want.abs().max() / 4 + want.abs())).all()
              and rel_err(got, want) <= GEMM_REL
              and torch.isfinite(got).all())
    return ok, float(diff.max()), rel_err(got, want)


def gemm_plan_text(m: int, k: int, n: int, row_bytes: int) -> str:
    """The launch plan csrc/dq_gemm.cu gets for this call, "" for a tree
    whose gemm_plan has no path (--gemm-only also times older trees)."""
    if not hasattr(int8_ops, "GemmPlan"):
        return ""
    p = int8_ops.gemm_plan(m, k, n, row_bytes)
    return f" [{p.path}, {p.splits} x {p.tps} K tiles]"


SUMMARY_ROWS = (80, TOWER_ROWS, 2492)  # the wgmma path's rows in the summary
HOST_CALLS = 200  # calls behind the wrappers' host time


def check_w4_gemm(gen: torch.Generator) -> dict:
    """K7 against w4_gemm_plain at the packed-int4 matmul shapes of
    llava-1.5-7b and Mistral-7B, per-channel and g=128 scales, at GEMM_ROWS
    rows; timed at the 7B shapes with g=128 beside its plain version, K6 (up
    to 80 rows) and the library route, dequantize then torch.matmul; the
    Function's dx against g @ dequant(W).T. The JSON line carries gate/up at
    16 rows, g=128: the beam step's shape."""
    dev = "cuda"
    layers = 4
    worst = 0.0
    timing = None
    summary = []
    for k, n in W4_SHAPES + MISTRAL_W4_SHAPES:
        np_ = n // 2
        timed_shape = (k, n) in W4_SHAPES
        # random bytes: every nibble occurs, -8 included; `layers` distinct
        # weights so that timed small-M calls read device memory, not L2
        w = torch.randint(-128, 128, (layers, k, np_), generator=gen,
                          device=dev, dtype=torch.int8)
        for groups in (1, k // W4_GROUP):
            s = (torch.rand(layers, 2, groups, np_, generator=gen,
                            device=dev) * 0.02 + 0.005).bfloat16()
            for m in GEMM_ROWS:
                x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
                ok, err, rel = True, 0.0, 0.0
                for li in (0, layers - 1):
                    got = w4_gemm(x, w[li], s[li])
                    want = w4_gemm_plain(x, w[li], s[li])
                    torch.cuda.synchronize()
                    good, e, r = gemm_within(got, want)
                    ok, err, rel = ok and good, max(err, e), max(rel, r)
                    del got, want
                line = (f"w4_gemm M={m} K={k} N={n} G={groups}"
                        f"{gemm_plan_text(m, k, n, np_)}: max_abs_err "
                        f"{err:.3e} rel {rel:.3e} (limits {GEMM_RTOL}*(max|"
                        f"plain|/4 + |plain|), rel {GEMM_REL})")
                if timed_shape and groups > 1:
                    def walk(fn):
                        for li in range(layers):
                            fn(x, w[li], s[li])

                    ms = device_ms(lambda: walk(w4_gemm)) / layers
                    plain_ms = device_ms(lambda: walk(w4_gemm_plain),
                                         iters=5) / layers
                    lib_ms = device_ms(lambda: walk(
                        lambda x_, w_, s_: x_ @ dequantize_int4(
                            w_, s_, torch.bfloat16))) / layers
                    nbytes = k * np_ + 2 * groups * np_ * 2
                    lim = bound(nbytes + tensor_bytes(x) + m * n * 2,
                                2 * m * k * n)
                    line += (f"; kernel {ms:.4f} ms "
                             f"({2 * m * k * n / ms / 1e9:.1f} TFLOP/s, "
                             f"{nbytes / ms / 1e6:.0f} GB/s of packed "
                             f"weights), plain {plain_ms:.4f} ms, dequantize"
                             f" + torch.matmul {lib_ms:.4f} ms, bound "
                             f"{lim['bound_ms']:.4f} ms by {lim['bound_by']}")
                    if m <= 80:
                        k6 = device_ms(lambda: walk(
                            lambda x_, w_, s_: w4_dense_stacked(
                                x_, {"kernel_q4p": w_, "kernel_scale4p": s_}))
                        ) / layers
                        line += f", K6 {k6:.4f} ms"
                    if (k, n, m) == (4096, 11008, 16):
                        timing = {"ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, **lim}
                    if m in SUMMARY_ROWS:
                        summary.append((f"K7 {k}x{n} g={W4_GROUP}", m, ms,
                                        plain_ms, lib_ms, lim))
                print(line + f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("w4_gemm disagrees with its plain "
                                         "version")
                worst = max(worst, err)
            del s
        del w
    # the Function's backward at the rows of one train forward
    k, n = W4_SHAPES[1]
    w = torch.randint(-128, 128, (k, n // 2), generator=gen, device=dev,
                      dtype=torch.int8)
    s = (torch.rand(2, k // W4_GROUP, n // 2, generator=gen, device=dev)
         * 0.02 + 0.005).bfloat16()
    x = torch.randn(TRAIN_ROWS, k, generator=gen,
                    device=dev).bfloat16().requires_grad_()
    g = torch.randn(TRAIN_ROWS, n, generator=gen, device=dev).bfloat16()
    (dx,) = torch.autograd.grad(w4_gemm(x, w, s), x, g)
    want = g @ dequantize_int4(w, s, torch.bfloat16).t()
    torch.cuda.synchronize()
    ok = torch.equal(dx, want)
    print(f"w4_gemm dx M={TRAIN_ROWS} K={k} N={n}: the Function's backward "
          f"equals g @ dequant(W).T bit for bit {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("w4_gemm's backward is not g @ dequant(W).T")
    return {"name": "w4_gemm", "route": "cuda",
            "source": "halva_tpu_torch/csrc/dq_gemm.cu",
            "replaces": "halva_tpu/ops/w4_matmul.py:313",
            "max_abs_err": worst, **timing, "summary": summary}


# (K, N) of the int8 tree's denses: the LLM's three, lm_head, the projector's
# first linear, and CLIP ViT-L's three
W8_SHAPES = W4_SHAPES + ((4096, 32000), (1024, 4096), (1024, 1024),
                         (4096, 1024))
W8_ROWS = (4, 80, 2492)


def check_int8_matmul(gen: torch.Generator) -> dict:
    """K8 against int8_matmul_plain at the shapes of the int8 tree's denses,
    4, 80 and 2,492 rows (the tower's shapes also at its 2,308), timed beside
    its plain version, the library route (dequantize the weights, then
    torch.matmul: what w8_dense was) and W8A8 (int8_dense: torch._int_mm).
    The JSON line carries gate/up at 4 rows, the decode step's shape."""
    dev = "cuda"
    layers = 4
    worst = 0.0
    timing = None
    summary = []
    for k, n in W8_SHAPES:
        q = torch.randint(-127, 128, (layers, k, n), generator=gen,
                          device=dev, dtype=torch.int8)
        sc = (torch.rand(layers, 1, n, generator=gen, device=dev) * 0.002
              + 0.0005).bfloat16()
        rows = W8_ROWS + ((TOWER_ROWS,) if k == 1024 or n == 1024 else ())
        for m in rows:
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            ok, err, rel = True, 0.0, 0.0
            for li in (0, layers - 1):
                got = int8_matmul(x, q[li], sc[li])
                want = int8_matmul_plain(x, q[li], sc[li])
                torch.cuda.synchronize()
                good, e, r = gemm_within(got, want)
                ok, err, rel = ok and good, max(err, e), max(rel, r)
                del got, want

            def walk(fn):
                for li in range(layers):
                    fn(x, q[li], sc[li])

            ms = device_ms(lambda: walk(int8_matmul)) / layers
            plain_ms = device_ms(lambda: walk(int8_matmul_plain),
                                 iters=5) / layers
            lib_ms = device_ms(lambda: walk(
                lambda x_, q_, s_: x_ @ (q_.to(x_.dtype) * s_))) / layers
            w8a8_ms = device_ms(lambda: walk(quant.int8_dense)) / layers
            lim = bound(k * n + n * 2 + tensor_bytes(x) + m * n * 2,
                        2 * m * k * n)
            print(f"int8_matmul M={m} K={k} N={n}"
                  f"{gemm_plan_text(m, k, n, n)}: max_abs_err {err:.3e} rel "
                  f"{rel:.3e} (limits {GEMM_RTOL}*(max|plain|/4 + |plain|), "
                  f"rel {GEMM_REL}); kernel {ms:.4f} ms "
                  f"({2 * m * k * n / ms / 1e9:.1f} TFLOP/s, "
                  f"{k * n / ms / 1e6:.0f} GB/s of int8 weights), plain "
                  f"{plain_ms:.4f} ms, dequantize + torch.matmul "
                  f"{lib_ms:.4f} ms, W8A8 (int8_dense, torch._int_mm) "
                  f"{w8a8_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms by "
                  f"{lim['bound_by']} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("int8_matmul disagrees with its plain "
                                     "version")
            worst = max(worst, err)
            if (k, n, m) == (4096, 11008, 4):
                timing = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, **lim}
            if m in SUMMARY_ROWS:
                summary.append((f"K8 {k}x{n}", m, ms, plain_ms, lib_ms, lim))
        del q, sc
    return {"name": "int8_matmul", "route": "cuda",
            "source": "halva_tpu_torch/csrc/dq_gemm.cu",
            "replaces": "halva_tpu/ops/int8_matmul.py:24",
            "max_abs_err": worst, **timing, "summary": summary}


K6_ROWS = (1, 2, 4, 8)


def k6_rows_table(gen: torch.Generator) -> None:
    """K6 at 1, 2, 4 and 8 rows at the 7B decode shapes, g=128: device ms
    from CUDA-graph replays, plan and bound; runs on an older tree too, so
    that two builds of it are timed in one call."""
    dev, layers = "cuda", 4
    for k, n in W4_SHAPES:
        np_, groups = n // 2, k // W4_GROUP
        w = torch.randint(-128, 128, (layers, k, np_), generator=gen,
                          device=dev, dtype=torch.int8)
        s = (torch.rand(layers, 2, groups, np_, generator=gen, device=dev)
             * 0.02 + 0.005).bfloat16()
        for b in K6_ROWS:
            x = torch.randn(b, k, generator=gen, device=dev).bfloat16()

            def walk():
                for li in range(layers):
                    w4_dense_stacked(x, {"kernel_q4p": w[li],
                                         "kernel_scale4p": s[li]})

            ms = device_ms(walk) / layers
            nbytes = k * np_ + 2 * groups * np_ * 2
            lim = bound(nbytes + tensor_bytes(x) + b * n * 2, 2 * b * k * n)
            print(f"K6 rows table: B={b} K={k} N={n} G={groups} "
                  f"[{k6_plan_text(b, k, np_, groups)}]: kernel {ms:.4f} ms, "
                  f"bound {lim['bound_ms']:.4f} ms by {lim['bound_by']}, "
                  f"{nbytes / ms / 1e6:.0f} GB/s")
        # one PyTorch kernel over the same bytes: what a kernel that only
        # streams them takes on this card at this size
        sum_ms = device_ms(lambda: [w[li].view(torch.int32).sum(
            dtype=torch.int32) for li in range(layers)]) / layers
        clone_ms = device_ms(lambda: [w[li].clone()
                                      for li in range(layers)]) / layers
        print(f"K6 rows table: K={k} N={n}: torch.sum of the "
              f"{k * np_ / 1e6:.2f} MB of packed weights {sum_ms:.4f} ms, "
              f"a clone of them {clone_ms:.4f} ms")
        del w, s


def gemm_summary(checked: list) -> None:
    """One line per K7 / K8 call above 32 rows at 80, 2,308 and 2,492 rows:
    ms, bound, plain version, dequantize + torch.matmul."""
    for kern in checked:
        for what, m, ms, plain_ms, lib_ms, lim in kern["summary"]:
            print(f"{kern['name']} above 32 rows, {what} at M={m}: kernel "
                  f"{ms:.4f} ms, bound {lim['bound_ms']:.4f} ms by "
                  f"{lim['bound_by']} ({lim['bound_ms'] / ms:.1%} of it), "
                  f"plain {plain_ms:.4f} ms, dequantize + torch.matmul "
                  f"{lib_ms:.4f} ms ({lib_ms / ms:.2f}x the kernel's time)")


def gemm_plan_sweep(gen: torch.Generator) -> None:
    """K8 at CLIP's fc2 (4096 x 1024) at the tower's rows and K7 gate/up
    (g=128) at batch 80, then K6 at 4 rows and K7 at 16 (the decode-row
    loop), each under forced K-split plans beside its own plan; then the
    wrappers' host time per call on the mma.sync path (32 rows) and on the
    TMA + wgmma path (80 rows: two tensor maps encoded per call). Needs a
    tree whose gemm_plan has paths."""
    if not hasattr(int8_ops, "GemmPlan"):
        print("gemm plans: this tree's gemm_plan has no paths; not swept")
        return
    dev, layers = "cuda", 4
    cases = []
    k, n = 4096, 1024
    q = torch.randint(-127, 128, (layers, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    sc = (torch.rand(layers, n, generator=gen, device=dev) * 0.002
          + 0.0005).bfloat16()
    cases.append(("K8", 0, TOWER_ROWS, k, n, q, sc, 1, (1, 3, 5, 8)))
    k, n = W4_SHAPES[1]
    w = torch.randint(-128, 128, (layers, k, n // 2), generator=gen,
                      device=dev, dtype=torch.int8)
    s4 = (torch.rand(layers, 2, k // W4_GROUP, n // 2, generator=gen,
                     device=dev) * 0.02 + 0.005).bfloat16()
    cases.append(("K7", 1, BATCH80, k, n, w, s4, k // W4_GROUP, (1, 2, 3, 6)))
    for what, mode, m, k, n, wt, st, groups, forced in cases:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        own = int8_ops.gemm_plan(m, k, n, wt.shape[-1])
        want = int8_ops.launch_dq_gemm(mode, "sweep", x, wt[0], st[0], n,
                                       groups)
        parts = []
        for want_splits in sorted(set(forced) | {own.splits}):
            splits, tps = int8_ops.split_k(k // int8_ops.TILE_K,
                                           want_splits)
            plan = own._replace(splits=splits, tps=tps)

            def walk():
                for li in range(layers):
                    int8_ops.launch_dq_gemm(mode, "sweep", x, wt[li], st[li],
                                            n, groups, plan)

            got = int8_ops.launch_dq_gemm(mode, "sweep", x, wt[0], st[0], n,
                                          groups, plan)
            if not gemm_within(got, want)[0]:
                raise AssertionError(f"{what} under plan {plan} disagrees "
                                     "with its own plan")
            ms = device_ms(walk) / layers
            mark = " (its plan)" if plan == own else ""
            parts.append(f"{plan.splits} x {plan.tps}{mark} {ms:.4f} ms")
        print(f"gemm plans, {what} M={m} K={k} N={n}: " + ", ".join(parts))
    # the decode-row loop: K6 at the smoke's batch and K7 at a beam step's
    # rows, gate/up g=128, under forced split counts beside the plan's
    k, n = W4_SHAPES[1]
    kt = k // int8_ops.TILE_K
    x4 = torch.randn(4, k, generator=gen, device=dev).bfloat16()
    x16 = torch.randn(16, k, generator=gen, device=dev).bfloat16()
    try:
        own = w4_matmul.plan(4, k, n // 2, k // W4_GROUP)
    except TypeError:
        own = None  # an older tree's K6 takes no forced plan
    if own is not None:
        parts = []
        for want_splits in sorted({1, 2, 3, 4, 6, own[1]}):
            tps = -(-2 * kt // want_splits)
            plan = (own[0], -(-2 * kt // tps), tps * 32)

            def walk6():
                for li in range(layers):
                    w4_dense_stacked(x4, {"kernel_q4p": w[li],
                                          "kernel_scale4p": s4[li]}, plan)

            mark = " (its plan)" if plan == own else ""
            parts.append(f"{plan[1]} x {plan[2]} rows{mark} "
                         f"{device_ms(walk6) / layers:.4f} ms")
        print(f"gemm plans, K6 B=4 K={k} N={n}: " + ", ".join(parts))
    own = int8_ops.gemm_plan(16, k, n, n // 2)
    parts = []
    for want_splits in sorted({1, 2, 3, 4, 6, own.splits}):
        splits, tps = int8_ops.split_k(kt, want_splits)
        plan = own._replace(splits=splits, tps=tps)

        def walk7():
            for li in range(layers):
                int8_ops.launch_dq_gemm(1, "sweep", x16, w[li], s4[li], n,
                                        k // W4_GROUP, plan)

        mark = " (its plan)" if plan == own else ""
        parts.append(f"{plan.splits} x {plan.tps}{mark} "
                     f"{device_ms(walk7) / layers:.4f} ms")
    print(f"gemm plans, K7 M=16 K={k} N={n} [{own.path}, {own.bm}-row "
          f"tiles]: " + ", ".join(parts))
    _kernels.launches.pop("sweep", None)
    k, n = W4_SHAPES[0]
    w = torch.randint(-128, 128, (k, n // 2), generator=gen, device=dev,
                      dtype=torch.int8)
    s4 = (torch.rand(2, k // W4_GROUP, n // 2, generator=gen, device=dev)
          * 0.02 + 0.005).bfloat16()
    host = {}
    small = int8_ops.SMALL_M
    for m in (small, BATCH80):
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        for _ in range(10):
            w4_gemm(x, w, s4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            w4_gemm(x, w, s4)
        host[m] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
    print(f"gemm host time per w4_gemm call (wq, {HOST_CALLS} calls, "
          f"enqueue only): {host[small]:.1f} us at {small} rows "
          f"(mma.sync path), {host[BATCH80]:.1f} us at {BATCH80} rows (TMA "
          f"+ wgmma path, two tensor maps encoded per call)")


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
    return tuple(torch.from_numpy(x).to(DEVICE) for x in (ids, images, lens))


def run_bf16(kernels: dict) -> dict:
    """The bf16 main path at full width, then the plain path beside it.
    Returns the bf16 param tree."""
    cfg = LLAVA_V15_7B
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlavaModel(cfg, tree.init_params(cfg, gen, torch.bfloat16))
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
    """The int4g tree, quantized on the card from the bf16 tree (no_grad,
    not inference_mode: a train step may save its leaves for backward)."""
    with torch.no_grad():
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


def w4_mm_launches(rows: int, n: int) -> dict:
    """{kernel: n} for n packed-int4 decode-family matmuls at `rows` rows:
    K6 up to W4_GEMV_MAX_ROWS rows, K7 above (ops/w4_matmul.py)."""
    name = "w4_gemm" if rows > w4_matmul.W4_GEMV_MAX_ROWS else "w4_gemv"
    return {name: n}


def run_int4g(q4: dict, kernels: dict) -> torch.Tensor:
    """The int4g serving path at full width (int4 prompt KV), a short int8
    KV run, then the plain path beside the kernel path. Returns the main
    run's greedy tokens."""
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
                emb = perturbed(llama.embed(q4["llm"], tokens[:, step, None]),
                                noise if run == "floor" else None)
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
    return tokens


def in_vocab(tokens: torch.Tensor, cfg, eos: int = -1) -> bool:
    return bool((((tokens >= 0) & (tokens < cfg.llm.vocab_size))
                 | (tokens == eos)).all())


def timed_run(fn):
    """(result, seconds, launches) of fn(), the counts set to 0 just before
    it and read just after, the clock stopped after a synchronize."""
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_kernels.launches)


def record(kernels: dict, launches: dict, *names) -> None:
    for name in names:
        kernels[name]["launches"] = launches[name]


def beam_routes(params, cfg, inputs, kv_quant, suffix: str):
    """The kernel that beam_route="auto" (ops/decode_attention.
    auto_beam_route) takes for this tree's prompt caches, then the other
    route and its kernel: the beam runs' expected launches."""
    _, _, _, pc, pseg = _prefill_impl(params, cfg, *inputs, kv_quant=kv_quant)
    route = auto_beam_route({k: v[0] for k, v in pc.items()}, pseg, BEAMS)
    del pc
    names = {"fold": "fold_attn" + suffix,
             "grid": "decode_attn" + suffix + "_beam"}
    other = "grid" if route == "fold" else "fold"
    print(f"route: beam_route='auto' with {kv_quant or 'bf16'} prompt KV at "
          f"B={inputs[0].shape[0]}, {BEAMS} beams -> {route} "
          f"({names[route]})")
    return names[route], other, names[other]


def run_beam_spec_bf16(params: dict, kernels: dict) -> None:
    """Beam search and speculative decode on the bf16 tree, short: K5's bf16
    modes and K4's bf16 beam mode through the entry points (the beam run on
    the route "auto" takes, then a short run on the other)."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    n = BEAM_TOKENS_BF16
    with torch.inference_mode():
        main, other_route, other = beam_routes(params, cfg, inputs, False, "")
        stats = {}
        (tok, num), secs, launches = timed_run(lambda: generate_beam(
            params, cfg, *inputs, max_new_tokens=n, eos_id=-1,
            num_beams=BEAMS, stats=stats))
        expect_launches(launches, {"flash_fwd": layers, main: layers * n},
                        f"bf16 beam run ({BEAMS} beams, {n} tokens)")
        record(kernels, launches, main)
        ok = (in_vocab(tok, cfg) and bool((num == n).all())
              and bool(torch.isfinite(stats["best_scores"]).all())
              and stats["steps"] == n)
        print(f"bf16 beam run: {secs:.3f} s with its prefill, best scores "
              + ", ".join(f"{x:.3f}" for x in stats["best_scores"].tolist())
              + f"; hypotheses of {num.tolist()} tokens (budget {n}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("bf16 beam run: bad hypotheses or scores")

        (tok_g, _), _, launches = timed_run(lambda: generate_beam(
            params, cfg, *inputs, max_new_tokens=SHORT_TOKENS, eos_id=-1,
            num_beams=BEAMS, beam_route=other_route))
        expect_launches(launches, {"flash_fwd": layers,
                                   other: layers * SHORT_TOKENS},
                        f"bf16 beam run on the {other_route} route")
        record(kernels, launches, other)
        if not in_vocab(tok_g, cfg):
            raise AssertionError(f"bf16 {other_route}-route beam tokens out "
                                 "of range")

        (tok_s, num_s, st), _, launches = timed_run(
            lambda: generate_speculative(
                params, cfg, *inputs, max_new_tokens=n, eos_id=-1,
                draft_k=4))
        expect_launches(launches, {
            "flash_fwd": layers,
            "fold_attn_shared": layers * st["verify_steps"]},
            "bf16 speculative run (draft_k 4)")
        record(kernels, launches, "fold_attn_shared")
        ok = (in_vocab(tok_s, cfg) and bool((num_s == n).all())
              and st["emitted_tokens"] >= st["verify_steps"] >= 1)
        print(f"bf16 speculative run: {st} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("bf16 speculative run: bad tokens or stats")


def _step_times(q4, cfg, inputs, tokens):
    """Device ms, from CUDA-graph replays, of one greedy decode step, one
    beam step on each decode-attention route with the beam loop's selection
    and gen-cache reorder beside it, and one verify step at draft_k 4 and 8,
    all on one int4 prompt cache of the int4g tree at gen slot 8."""
    b = inputs[0].shape[0]
    out = {}
    with torch.inference_mode():
        _, _, slen, pc, pseg = _prefill_impl(q4, cfg, *inputs,
                                             kv_quant="int4")
        at = 8

        def decode(rows, **kw):
            gen_cache = init_gen_cache_like(cfg.llm, rows, NEW_TOKENS, pc)
            emb = llama.embed(q4["llm"], tokens[:, at, None]
                              .repeat_interleave(rows // b, dim=0))
            pos = (slen + at).repeat_interleave(rows // b)
            return device_ms(lambda: llama.decode_step(
                q4["llm"], cfg.llm, emb, pos, pc, pseg, gen_cache, at, **kw))

        out["greedy"] = decode(b)
        out["beam"] = decode(b * BEAMS, beam_k=BEAMS)  # the "auto" route
        out["beam_fold"] = decode(b * BEAMS, beam_k=BEAMS, beam_route="fold")
        out["beam_grid"] = decode(b * BEAMS, beam_k=BEAMS, beam_route="grid")

        # the beam loop's other two parts at the run's shapes: the selection
        # over random logits (so the parents are a real permutation), a few
        # steps in, and the reorder of the whole gen cache by its parents
        noise = torch.Generator(device=DEVICE).manual_seed(5)
        logits = torch.randn(b * BEAMS, cfg.llm.vocab_size, generator=noise,
                             device=DEVICE)
        state = init_beam_state(b, BEAMS, NEW_TOKENS, slen)
        for step in range(at):
            state, _ = select_step(state, logits, step, -1, 1.0)
        out["select"] = device_ms(
            lambda: select_step(state, logits, at, -1, 1.0))
        _, parent = select_step(state, logits, at, -1, 1.0)
        gen_cache = init_gen_cache_like(cfg.llm, b * BEAMS, NEW_TOKENS, pc)
        out["reorder"] = device_ms(
            lambda: reorder_gen_cache(gen_cache, parent))
        out["reorder_mb"] = tensor_bytes(*gen_cache.values()) / 1e6
        del gen_cache
        for kq in (4, SPEC_LONG[0]):
            gen_cache = init_gen_cache_like(cfg.llm, b, sum(SPEC_LONG), pc)
            emb = llama.embed(q4["llm"], tokens[:, at:at + kq])
            gen_len = torch.full((b,), at, dtype=torch.int32, device=DEVICE)
            out[f"verify_{kq}"] = device_ms(lambda: llama.verify_step(
                q4["llm"], cfg.llm, emb, slen + at, pc, pseg, gen_cache,
                gen_len))
    return out


def run_beam_spec_int4g(q4: dict, kernels: dict,
                        greedy_tokens: torch.Tensor) -> None:
    """Beam search (4 beams, 32 tokens) and speculative greedy decode
    (draft_k 4 over 32 tokens, draft_k 8 over 200) on the int4g tree with an
    int4 prompt KV cache, each beside the greedy decode of the same tree and
    batch in this call (the beam run on the route beam_route="auto" takes);
    short runs of the other beam route and of the int8 KV modes on both
    routes; one verify step against the plain path."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]
    kv = dict(eos_id=-1, kv_quant="int4")
    with torch.inference_mode():
        _, prefill_s, _ = timed_run(lambda: _prefill_impl(
            q4, cfg, *inputs, kv_quant="int4"))
        (_, _), greedy_s, _ = timed_run(lambda: generate_greedy(
            q4, cfg, *inputs, max_new_tokens=NEW_TOKENS, **kv))
        greedy_ms = (greedy_s - prefill_s) / NEW_TOKENS * 1e3

        # ---- the beam main path
        main, other_route, other = beam_routes(q4, cfg, inputs, "int4",
                                               "_kv4")
        main8, other_route8, other8 = beam_routes(q4, cfg, inputs, "int8",
                                                  "_kv8")
        stats = {}
        (tok, num), beam_s, launches = timed_run(lambda: generate_beam(
            q4, cfg, *inputs, max_new_tokens=NEW_TOKENS, num_beams=BEAMS,
            stats=stats, **kv))
        # per beam step: the beam route's attention once and the
        # packed-int4 matmul seven times per layer, at 16 rows: K7 by the
        # row rule
        mm = w4_mm_launches(b * BEAMS, 7 * layers * NEW_TOKENS)
        expect_launches(launches, {
            "flash_fwd": layers, main: layers * NEW_TOKENS, **mm},
            f"int4g beam run ({BEAMS} beams, {NEW_TOKENS} tokens)")
        record(kernels, launches, main, *mm)
        ok = (in_vocab(tok, cfg) and bool((num == NEW_TOKENS).all())
              and bool(torch.isfinite(stats["best_scores"]).all())
              and stats["steps"] == NEW_TOKENS)
        beam_ms = (beam_s - prefill_s) / NEW_TOKENS * 1e3
        print(f"int4g beam main path: {beam_ms:.3f} ms per beam step "
              f"({BEAMS} beams x {b} items) against {greedy_ms:.3f} ms per "
              f"greedy step of the same tree and batch in this call: ratio "
              f"{beam_ms / greedy_ms:.3f} on the host clock; best scores "
              + ", ".join(f"{x:.2f}" for x in stats["best_scores"].tolist())
              + f"; hypotheses of {num.tolist()} tokens "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("int4g beam run: bad hypotheses or scores")

        # ---- further modes and routes, short
        for what, fn, want in (
            (f"int4g beam run on the {other_route} route",
             lambda: generate_beam(q4, cfg, *inputs,
                                   max_new_tokens=SHORT_TOKENS,
                                   num_beams=BEAMS, beam_route=other_route,
                                   **kv),
             {other: layers * SHORT_TOKENS}),
            ("int8-KV beam run",
             lambda: generate_beam(q4, cfg, *inputs,
                                   max_new_tokens=SHORT_TOKENS,
                                   num_beams=BEAMS, eos_id=-1,
                                   kv_quant="int8"),
             {main8: layers * SHORT_TOKENS}),
            (f"int8-KV beam run on the {other_route8} route",
             lambda: generate_beam(q4, cfg, *inputs,
                                   max_new_tokens=SHORT_TOKENS,
                                   num_beams=BEAMS, eos_id=-1,
                                   kv_quant="int8", beam_route=other_route8),
             {other8: layers * SHORT_TOKENS}),
        ):
            (tok_x, _), _, launches = timed_run(fn)
            expect_launches(launches, {
                "flash_fwd": layers,
                **w4_mm_launches(b * BEAMS, 7 * layers * SHORT_TOKENS),
                **want}, what)
            record(kernels, launches, *want)
            if not in_vocab(tok_x, cfg):
                raise AssertionError(f"{what}: tokens out of range")

        # ---- speculative greedy decode
        # the draft_k 4 runs are the main path of their rows of the
        # `kernels` line (whose times are the K=4 ones); the long run's
        # launches are asserted and printed, not recorded there
        for draft_k, n, kv_quant, name, main_path in (
                (4, NEW_TOKENS, "int4", "fold_attn_kv4_shared", True),
                (*SPEC_LONG, "int4", "fold_attn_kv4_shared", False),
                (4, SHORT_TOKENS, "int8", "fold_attn_kv8_shared", True)):
            (tok_s, num_s, st), spec_s, launches = timed_run(
                lambda: generate_speculative(
                    q4, cfg, *inputs, max_new_tokens=n, eos_id=-1,
                    draft_k=draft_k, kv_quant=kv_quant))
            steps = st["verify_steps"]
            what = (f"int4g speculative run (draft_k {draft_k}, {n} tokens, "
                    f"{kv_quant} KV)")
            # per verify step: K5 shared once, the packed-int4 matmul seven
            # times per layer at B * draft_k rows
            expect_launches(launches, {
                "flash_fwd": layers, name: layers * steps,
                **w4_mm_launches(b * draft_k, 7 * layers * steps)}, what)
            if main_path:
                record(kernels, launches, name)
            ok = (in_vocab(tok_s, cfg) and bool((num_s == n).all())
                  and st["emitted_tokens"] >= steps >= 1)
            line = f"{what}: {st}, {launches[name]} launches of {name}"
            if kv_quant == "int4":
                verify_ms = (spec_s - prefill_s) / steps * 1e3
                ref = greedy_tokens[:, :n]
                same = (tok_s[:, :ref.shape[1]] == ref)
                prefix = same.int().cumprod(dim=1).sum(dim=1).tolist()
                line += (f"; {verify_ms:.3f} ms per verify step against "
                         f"{greedy_ms:.3f} ms per decode step (ratio "
                         f"{verify_ms / greedy_ms:.3f}, host clock), "
                         f"{st['emitted_tokens'] / b / steps:.3f} tokens per "
                         "row per verify step (random weights: no finding); "
                         f"agreement with the greedy run's tokens "
                         f"{float(same.float().mean()):.3f} over "
                         f"{ref.shape[1]} tokens, equal prefixes {prefix}")
            print(line + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{what}: bad tokens or stats")

    # ---- device time of one step of each kind, same cache, CUDA graphs
    t = _step_times(q4, cfg, inputs, greedy_tokens)
    print("int4g step device times (CUDA-graph replays, gen slot 8): greedy "
          f"{t['greedy']:.3f} ms; beam step {t['beam']:.3f} ms on the "
          f"'auto' route (ratio {t['beam'] / t['greedy']:.3f}): "
          f"{t['beam_fold']:.3f} ms with K5, "
          f"{t['beam_grid']:.3f} ms with K4's beam route; verify step "
          f"draft_k 4 {t['verify_4']:.3f} ms (ratio "
          f"{t['verify_4'] / t['greedy']:.3f}), draft_k {SPEC_LONG[0]} "
          f"{t[f'verify_{SPEC_LONG[0]}']:.3f} ms (ratio "
          f"{t[f'verify_{SPEC_LONG[0]}'] / t['greedy']:.3f})")
    whole = t["beam"] + t["select"] + t["reorder"]
    print(f"int4g beam loop parts on the device (a graph each): model step "
          f"{t['beam']:.3f} ms ({t['beam'] / whole:.1%}), selection "
          f"{t['select']:.3f} ms ({t['select'] / whole:.1%}), gen-cache "
          f"reorder (index_select of {t['reorder_mb']:.1f} MB by parent beam) "
          f"{t['reorder']:.3f} ms ({t['reorder'] / whole:.1%}); with them the"
          f" beam step is {whole / t['greedy']:.3f} x the greedy step")
    # the same steps with every matmul on K6 (the rule switched off), in
    # this call: what the row rule buys
    rule = w4_matmul.W4_GEMV_MAX_ROWS
    w4_matmul.W4_GEMV_MAX_ROWS = 1 << 30
    try:
        t6 = _step_times(q4, cfg, inputs, greedy_tokens)
    finally:
        w4_matmul.W4_GEMV_MAX_ROWS = rule
    print(f"route: W4_GEMV_MAX_ROWS = {rule}: a packed-int4 decode-family "
          f"matmul takes K6 up to {rule} rows and K7 above (16 rows per beam "
          f"step, 16 and 32 per verify step). With K6 at every row count the "
          f"steps take: beam {t6['beam']:.3f} ms (K7: "
          f"{t['beam']:.3f}), verify draft_k 4 {t6['verify_4']:.3f} "
          f"(K7: {t['verify_4']:.3f}), draft_k {SPEC_LONG[0]} "
          f"{t6[f'verify_{SPEC_LONG[0]}']:.3f} (K7: "
          f"{t[f'verify_{SPEC_LONG[0]}']:.3f}), greedy at 4 rows "
          f"{t6['greedy']:.3f} (K6 either way: {t['greedy']:.3f})")
    compare_verify(q4, cfg, inputs, greedy_tokens)
    run_batch80(q4, cfg)


BATCH80 = 80  # the reference benchmark's serving batch


def run_batch80(q4, cfg) -> None:
    """A short greedy run of 80 requests (the 4 requests 20 times) on the
    int4g tree with int4 prompt KV: K7's rows at the serving batch; then the
    device time of one decode step there on K7 and on K6."""
    layers = cfg.llm.num_layers
    inputs = tuple(t.repeat_interleave(BATCH80 // t.shape[0], dim=0)
                   for t in make_inputs(cfg))
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        (tok, num), secs, launches = timed_run(lambda: generate_greedy(
            q4, cfg, *inputs, max_new_tokens=SHORT_TOKENS, eos_id=-1,
            kv_quant="int4"))
        peak = torch.cuda.max_memory_allocated()
        expect_launches(launches, {
            "flash_fwd": layers, "decode_attn_kv4": layers * SHORT_TOKENS,
            **w4_mm_launches(BATCH80, 7 * layers * SHORT_TOKENS)},
            f"int4g greedy run at batch {BATCH80}")
        ok = in_vocab(tok, cfg) and bool((num == SHORT_TOKENS).all())
        _, _, slen, pc, pseg = _prefill_impl(q4, cfg, *inputs,
                                             kv_quant="int4")
        token = tok[:, SHORT_TOKENS - 1, None]
        ms = {}
        rule = w4_matmul.W4_GEMV_MAX_ROWS
        try:
            for name, rows in (("K7", rule), ("K6", 1 << 30)):
                w4_matmul.W4_GEMV_MAX_ROWS = rows
                ms[name] = decode_step_ms(q4, cfg, pc, pseg, slen, token,
                                          "auto")
        finally:
            w4_matmul.W4_GEMV_MAX_ROWS = rule
        del pc
    print(f"int4g greedy run at batch {BATCH80}: {SHORT_TOKENS} tokens x "
          f"{tok.shape[0]} rows in {secs:.3f} s with its prefill, peak memory "
          f"{peak / 2**30:.2f} GiB; one decode step on the device (a CUDA "
          f"graph, gen slot 8): {ms['K7']:.3f} ms with K7, {ms['K6']:.3f} ms "
          f"with K6 at every row count {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"batch {BATCH80}: tokens out of range")
    torch.cuda.empty_cache()


def compare_verify(q4, cfg, inputs, tokens) -> None:
    """One verify step's logits (draft_k 4, the greedy run's first tokens as
    candidates, empty gen cache), kernel path (K7 at 16 rows, K5 shared)
    against plain path, beside the noise floor: plain path with the
    candidate embeddings perturbed by 2^-7 N(0, 1) relative."""
    b, kq = inputs[0].shape[0], 4
    noise = torch.Generator(device=DEVICE).manual_seed(4)
    with torch.inference_mode():
        _, _, slen, pc, pseg = _prefill_impl(q4, cfg, *inputs,
                                             kv_quant="int4")
        runs = {}
        for run, impl in (("auto", "auto"), ("plain", "plain"),
                          ("floor", "plain")):
            gen_cache = init_gen_cache_like(cfg.llm, b, NEW_TOKENS, pc)
            emb = perturbed(llama.embed(q4["llm"], tokens[:, :kq]),
                            noise if run == "floor" else None)
            gen_len = torch.zeros((b,), dtype=torch.int32, device=DEVICE)
            runs[run], _ = llama.verify_step(
                q4["llm"], cfg.llm, emb, slen, pc, pseg, gen_cache, gen_len,
                attn_impl=impl)
    finite = all(bool(torch.isfinite(r).all()) for r in runs.values())
    err = rel_err(runs["auto"], runs["plain"])
    floor = rel_err(runs["floor"], runs["plain"])
    agree = float((runs["auto"].argmax(-1) == runs["plain"].argmax(-1))
                  .float().mean())
    ok = finite and err <= TRAIN_FLOOR_FACTOR * floor
    print(f"int4g verify step kernel vs plain path: logits rel err {err:.3e},"
          f" noise floor {floor:.3e}, bound {TRAIN_FLOOR_FACTOR:.3f} x floor;"
          f" argmax agreement {agree:.3f} over {kq} positions x {b} rows; "
          f"logits finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("verify step: kernel path disagrees with the "
                             "plain path")


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


def run_train(params: dict, kernels: dict, cfg=None, what: str = "",
              suffix: str = "", micro_steps: int = TRAIN_MICRO_STEPS,
              grad_accum: int = 2, compare: bool = True) -> None:
    """The DPA LoRA train step at full width (llava-v1.5-7b unless `cfg`
    says otherwise): bf16 base, bf16 LoRA r=128 alpha=256 on the 7 linears
    of all layers, remat per layer, loss_chunk=256, micro-batch 2, AdamW
    with warmup and cosine decay, `grad_accum` micro-steps per update;
    `micro_steps` micro-steps, two updates in all (the first at lr(0) = 0).
    `suffix` is the flash kernels' mode on this config. Then, with
    `compare`, one micro-step on the kernel path against the plain path. A
    quantized `params` is the frozen base as it is (its denses launch no
    kernel here: W8A8 is a library product, NF4 and int4 dequantize)."""
    cfg = cfg or CFG
    layers = cfg.llm.num_layers
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    policy = add_lora(params, gen, rank=128, alpha=256.0)
    tcfg = TrainConfig(grad_accum_steps=grad_accum, num_train_steps=400,
                       remat=True, loss_chunk=256)
    trainable, frozen, opt, opt_state = init_train_state(policy, tcfg)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    batches = [train_batch(cfg, seed) for seed in range(micro_steps)]
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
        print(f"{what}train micro-step {i}: loss {vals[0]:.6f} alignment "
              f"{vals[1]:.6f} kl {vals[2]:.3e} grad_norm {vals[3]:.4e}; "
              f"{times[-1] * 1e3:.1f} ms; updates applied {opt.updates} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train step: a loss is not finite or the "
                                 "grad norm is 0")
        # per layer: K1 in the pos+neg, policy-ref and frozen-ref forwards
        # and in the remat recompute of the two forwards with grad; K2 and
        # K3 in the backward of those two
        expect_launches(per_step, {"flash_fwd" + suffix: 5 * layers,
                                   "flash_bwd_dq" + suffix: 2 * layers,
                                   "flash_bwd_dkv" + suffix: 2 * layers},
                        f"{what}train micro-step {i}")
        if opt.updates and (i + 1) % tcfg.grad_accum_steps == 0:
            sums.append(bit_sums(policy))
    for name in ("flash_bwd_dq" + suffix, "flash_bwd_dkv" + suffix):
        kernels[name]["launches"] = seen.get(name, 0)

    lora_paths = {p for p, t in tree.flatten(trainable) if t is not None}
    first, second = changed(sums[0], sums[1]), changed(sums[1], sums[2])
    ok = (opt.updates == 2 and not first and second
          and set(second) <= lora_paths)
    print(f"{what}train updates: {opt.updates}; leaves changed by update 1 (lr(0) "
          f"= 0): {len(first)}; by update 2: {len(second)} of "
          f"{len(lora_paths)} LoRA leaves ({n_lora / 1e6:.1f} M params), "
          f"{len(set(second) - lora_paths)} others "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the optimizer changed other leaves than LoRA's,"
                             " or none")
    steady = times[1:]
    print(f"{what}train main path ({gpu_line()}): "
          f"{statistics.mean(steady) * 1e3:.1f} ms per micro-step (mean of "
          f"micro-steps 1-{len(times) - 1}; all: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" ms), B={TRAIN_B} rows of {TRAIN_SPLICED} spliced tokens, "
          f"peak memory {peak / 2**30:.2f} GiB")
    del policy, trainable, frozen, opt, opt_state, step
    if compare:
        compare_train(params, batches[0], cfg, what)


def compare_train(params: dict, batch: dict, cfg=None,
                  what: str = "") -> None:
    """One micro-step's loss parts and LoRA grads, kernel path against plain
    path, beside the noise floor; on a tree whose lora_b is small and
    nonzero (at B = 0 the KL and the lora_a grads are exactly 0). The two
    loss parts are scalars, and the relative change of a scalar under one
    random perturbation is itself a random draw that can land near 0: the
    floor of each quantity is the largest of FLOOR_DRAWS independent
    perturbations, every one of which is printed."""
    cfg = cfg or CFG
    cmp = comparison_policy(params)
    noise = torch.Generator(device=DEVICE).manual_seed(3)
    runs = {"kernel": micro_step_grads(cmp, batch, cfg),
            "plain": micro_step_grads(cmp, batch, cfg, impl="plain")}
    for i in range(FLOOR_DRAWS):
        runs[f"floor{i}"] = micro_step_grads(cmp, batch, cfg, noise, "plain")

    def errs(run):
        got, want = runs[run], runs["plain"]
        return (abs(got[0] - want[0]) / abs(want[0]),
                abs(got[1] - want[1]) / abs(want[1]),
                rel_err(got[2], want[2]))

    got = errs("kernel")
    draws = [errs(f"floor{i}") for i in range(FLOOR_DRAWS)]
    floor = tuple(max(x) for x in zip(*draws))
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in
                 runs.values())
    ok = finite and all(e <= TRAIN_FLOOR_FACTOR * f
                        for e, f in zip(got, floor))
    names = ("alignment", "kl", "LoRA grads")
    print(f"{what}train kernel vs plain path (one micro-step, lora_b ~ "
          f"{LORA_B_STD} N(0,1)): plain alignment {runs['plain'][0]:.6f}, "
          f"kl {runs['plain'][1]:.4e}; rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, got))
          + "; noise floor (plain vs plain with the text embeddings x (1 + "
          f"2^-7 N(0,1)), the largest of {FLOOR_DRAWS} draws) "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, floor))
          + "; the draws: " + "; ".join(
              "/".join(f"{e:.3e}" for e in d) for d in draws)
          + f"; bound {TRAIN_FLOOR_FACTOR:.3f} x floor "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}train kernel path disagrees with the "
                             "plain path")


def count_denses(node, key: str) -> int:
    """How many denses of a tree hold `key`: a stacked (L, in, out) leaf
    counts L."""
    if isinstance(node, (list, tuple)):
        return sum(count_denses(v, key) for v in node)
    if not isinstance(node, dict):
        return 0
    if key in node:
        return node[key].shape[0] if node[key].ndim == 3 else 1
    return sum(count_denses(v, key) for v in node.values())


def run_int8_serving(q8: dict, kernels: dict) -> None:
    """Greedy decode of the 4 requests on the int8 tree (every dense kernel
    and the embedding int8), on its two routes: weight-only (W8A8 off:
    w8_dense, K8 for every quantized dense) and W8A8 (int8_dense,
    torch._int_mm: no K8 launch). Launches asserted from the tree's own
    count of denses, one decode step of each route timed on the device, and
    the logits of the K8 route held against attn_impl="plain" and against
    the W8A8 route beside the noise floor. The switch is restored."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]
    n = SHORT_TOKENS
    vit = cfg.vision
    tower_run = cfg.mm_vision_select_layer % (vit.num_layers + 1)
    per_pass = count_denses(q8["llm"]["layers"], "kernel_q") + count_denses(
        q8["llm"]["lm_head"], "kernel_q")
    prefill_only = (count_denses(q8["vision"]["layers"], "kernel_q")
                    // vit.num_layers * tower_run
                    + count_denses(q8["projector"], "kernel_q"))
    want_k8 = prefill_only + (1 + n) * per_pass
    was = quant.w8a8_enabled()
    results = {}
    try:
        for route, on in (("weight-only (K8)", False), ("W8A8", True)):
            quant.set_w8a8(on)
            with torch.inference_mode():
                generate_greedy(q8, cfg, *inputs, max_new_tokens=1,
                                eos_id=-1)  # warm-up, not counted
                _, prefill_s, _ = timed_run(lambda: _prefill_impl(
                    q8, cfg, *inputs))
                (tok, num), secs, launches = timed_run(
                    lambda: generate_greedy(q8, cfg, *inputs,
                                            max_new_tokens=n, eos_id=-1))
                want = {"flash_fwd": layers, "decode_attn": layers * n}
                if not on:
                    want["int8_matmul"] = want_k8
                expect_launches(launches, want, f"int8 tree, {route} route")
                if not on:
                    record(kernels, launches, "int8_matmul")
                if not (in_vocab(tok, cfg) and bool((num == n).all())):
                    raise AssertionError(f"int8 tree, {route}: bad tokens")
                _, _, slen, pc, pseg = _prefill_impl(q8, cfg, *inputs)
                step_ms = decode_step_ms(q8, cfg, pc, pseg, slen,
                                         tok[:, n - 1, None], "auto")
                del pc
                results[route] = (tok, prefill_s, secs, step_ms)
        tok, prefill_s, secs, step_ms = results["weight-only (K8)"]
        _, prefill8_s, secs8, step8_ms = results["W8A8"]
        print(f"route: HALVA_W8A8 / quant.set_w8a8 (default on, restored to "
              f"{was}): off -> dense sends every kernel_q to w8_dense, K8 on "
              f"the card ({want_k8} launches for {n} tokens: {tower_run} "
              f"tower layers x 6, the projector's 2, {per_pass} per LLM pass "
              f"with lm_head, {1 + n} passes, counted from the tree); on -> "
              "int8_dense, torch._int_mm, no launch")
        print(f"int8 tree serving ({tree_bytes(q8) / 1e9:.3f} GB): "
              f"weight-only route prefill {prefill_s * 1e3:.2f} ms, decode "
              f"step {step_ms:.3f} ms of device time (a CUDA graph, B={b}), "
              f"{(secs - prefill_s) / n * 1e3:.3f} ms on the host clock; "
              f"W8A8 route prefill {prefill8_s * 1e3:.2f} ms, decode step "
              f"{step8_ms:.3f} ms of device time, "
              f"{(secs8 - prefill8_s) / n * 1e3:.3f} ms on the host clock")
        # logits: K8 route kernel vs plain attention, and W8A8 vs K8 route,
        # beside the floor (K8 route, plain, embeddings perturbed)
        noise = torch.Generator(device=DEVICE).manual_seed(9)
        quant.set_w8a8(False)
        with torch.inference_mode():
            runs = {"auto": family_logits(q8, cfg, inputs, tok, "auto"),
                    "plain": family_logits(q8, cfg, inputs, tok, "plain"),
                    "floor": family_logits(q8, cfg, inputs, tok, "plain",
                                           noise)}
            quant.set_w8a8(True)
            w8a8 = family_logits(q8, cfg, inputs, tok, "auto")
    finally:
        quant.set_w8a8(was)
    floor_check(runs, f"int8 tree (weight-only route) first token and decode "
                f"steps 0-{COMPARE_STEPS - 1}:")
    err = [rel_err(w8a8[i], runs["auto"][i]) for i in range(w8a8.shape[0])]
    floor = [rel_err(runs["floor"][i], runs["plain"][i])
             for i in range(w8a8.shape[0])]
    ok = bool(torch.isfinite(w8a8).all()) and all(
        e <= W8A8_FLOOR_FACTOR * f for e, f in zip(err, floor))
    print("int8 tree W8A8 route vs weight-only route: logits rel err "
          + ", ".join(f"{e:.3e}" for e in err)
          + "; the floor above " + ", ".join(f"{e:.3e}" for e in floor)
          + f"; bound {W8A8_FLOOR_FACTOR} x floor (W8A8 rounds the "
          "activations of every dense to int8, the floor perturbs the "
          f"embeddings once) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 tree: the two routes disagree")


def dequantized_tree(node):
    """A quantized tree as a bf16 `kernel` / `embedding` tree of the same
    weights: each leaf dequantized as the port's dense and embed do it."""
    if isinstance(node, (list, tuple)):
        return [dequantized_tree(v) for v in node]
    if not isinstance(node, dict):
        return node
    out = {k: dequantized_tree(v) for k, v in node.items()
           if k not in ("kernel_q", "kernel_scale", "kernel_q4",
                        "kernel_scale4", "kernel_q4p", "kernel_scale4p",
                        "embedding_q", "embedding_scale")}
    if "kernel_q" in node:
        out["kernel"] = quant.dequantize_kernel(node)
    elif "kernel_q4" in node:
        out["kernel"] = quant._nf4_dequant(
            node["kernel_q4"], node["kernel_scale4"], torch.bfloat16)
    elif "kernel_q4p" in node:
        q, sc = node["kernel_q4p"], node["kernel_scale4p"]
        if q.ndim == 3:
            out["kernel"] = torch.stack([
                dequantize_int4(q[li], sc[li], torch.bfloat16)
                for li in range(q.shape[0])])
        else:
            out["kernel"] = dequantize_int4(q, sc, torch.bfloat16)
    if "embedding_q" in node:
        out["embedding"] = (node["embedding_q"].float()
                            * node["embedding_scale"].float()).bfloat16()
    return out


def comparison_policy(params: dict) -> dict:
    """`params` with LoRA r=128 whose lora_b is small and nonzero (at B = 0
    the KL and the lora_a grads are exactly 0), from seed 2: the same
    factors on any tree with the same denses."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cmp = add_lora(params, gen, rank=128, alpha=256.0)
    for group in ("attn", "mlp"):
        for p in cmp["llm"]["layers"][group].values():
            p["lora_b"] = (torch.randn(p["lora_b"].shape, generator=gen,
                                       device=DEVICE) * LORA_B_STD).to(
                                           p["lora_b"].dtype)
    return cmp


def micro_step_grads(policy: dict, batch: dict, cfg, noise=None,
                     impl: str = "auto"):
    """(alignment, kl, flat LoRA grads) of one DPA micro-step on `policy`
    on path `impl`; with `noise`, the text-embedding table is perturbed."""
    tcfg = TrainConfig(grad_accum_steps=1, num_train_steps=400, remat=True,
                       loss_chunk=256, attn_impl=impl)
    trainable, frozen, opt, _ = init_train_state(policy, tcfg)
    if noise is not None:
        frozen = tree.map_tree(lambda x: x, frozen)
        frozen["llm"]["embed"]["embedding"] = perturbed(
            frozen["llm"]["embed"]["embedding"], noise)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    _, parts, grads = step.loss_and_grads(trainable, frozen, None, batch)
    flat = torch.cat([g.float().flatten() for _, g in tree.flatten(grads)
                      if g is not None])
    torch.cuda.synchronize()
    return float(parts.alignment), float(parts.divergence), flat


def run_train_quant(qtree: dict, kernels: dict, what: str,
                    grad_factor: float) -> None:
    """The DPA LoRA train step of llava-v1.5-7b on a quantized frozen base
    (the bf16 phase's recipe, ref_params=None, 2 micro-steps at grad_accum
    1), then the check that a missing backward through a quantized dense
    fails: one micro-step's LoRA grads on this base against the same
    micro-step on the base dequantized to a bf16 tree, by relative error of
    the whole grad vector, within `grad_factor` of the noise floor (the
    dequantized tree against itself with its text embeddings perturbed by
    2^-7 N(0, 1) relative, the largest of FLOOR_DRAWS draws)."""
    cfg = LLAVA_V15_7B
    print(f"{what} base: {tree_bytes(qtree) / 1e9:.3f} GB, "
          f"{count_denses(qtree, 'kernel_q')} int8, "
          f"{count_denses(qtree, 'kernel_q4')} NF4 and "
          f"{count_denses(qtree, 'kernel_q4p')} packed-int4 denses, "
          f"{'int8' if 'embedding_q' in qtree['llm']['embed'] else 'float'} "
          "embedding")
    run_train(qtree, kernels, cfg, f"{what} base ", "", FAMILY_MICRO_STEPS,
              grad_accum=1, compare=False)
    torch.cuda.empty_cache()
    batch = train_batch(cfg, 0)
    got = micro_step_grads(comparison_policy(qtree), batch, cfg)
    deq = dequantized_tree(qtree)
    policy = comparison_policy(deq)
    want = micro_step_grads(policy, batch, cfg)
    noise = torch.Generator(device=DEVICE).manual_seed(3)
    draws = []
    for _ in range(FLOOR_DRAWS):
        f = micro_step_grads(policy, batch, cfg, noise)
        draws.append((abs(f[0] - want[0]) / abs(want[0]),
                      abs(f[1] - want[1]) / abs(want[1]),
                      rel_err(f[2], want[2])))
        del f
    floor = tuple(max(x) for x in zip(*draws))
    errs = (abs(got[0] - want[0]) / abs(want[0]),
            abs(got[1] - want[1]) / abs(want[1]), rel_err(got[2], want[2]))
    finite = bool(np.isfinite(got[0]) and np.isfinite(got[1])
                  and torch.isfinite(got[2]).all())
    ok = finite and errs[2] <= grad_factor * floor[2]
    names = ("alignment", "kl", "LoRA grads")
    print(f"{what} base vs the same weights as a bf16 tree (one micro-step, "
          f"lora_b ~ {LORA_B_STD} N(0,1)): alignment {got[0]:.6f} against "
          f"{want[0]:.6f}, kl {got[1]:.4e} against {want[1]:.4e}; rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
          + "; noise floor (bf16 tree vs itself with the text embeddings x "
          f"(1 + 2^-7 N(0,1)), the largest of {FLOOR_DRAWS} draws) "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, floor))
          + f"; LoRA grads bound {grad_factor:.3f} x floor (a dense without "
          "its backward reads ~1) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} base: LoRA grads disagree with the "
                             "dequantized tree's")
    del deq, policy, got, want
    torch.cuda.empty_cache()


def new_tree(cfg, name: str) -> dict:
    """A random bf16 tree of `cfg` on the card, from seed 0."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = LlavaModel(cfg, tree.init_params(cfg, gen, torch.bfloat16)).params
    torch.cuda.synchronize()
    llm = cfg.llm
    print(f"model: {name}, {llm.num_layers} layers, hidden {llm.hidden_size},"
          f" {llm.num_heads} heads over {llm.kv_heads} kv heads, MLP "
          f"{llm.intermediate_size} ({'gated' if llm.gated_mlp else 'plain'} "
          f"{llm.mlp_act}), {llm.norm_type}, {llm.position_embedding}, "
          f"window {llm.sliding_window}, vocab {llm.vocab_size}"
          f"{' tied' if llm.tie_word_embeddings else ''}; "
          f"{sum(t.numel() for _, t in tree.flatten(params)) / 1e9:.3f} B "
          f"random bf16 params from seed 0 in {time.perf_counter() - t0:.1f}"
          " s")
    return params


def decode_route(cfg, sp: int, sg: int) -> str:
    """Print which attention a decode step of `cfg` takes over an Sp-token
    prompt cache and an Sg-slot gen cache: the port's own answer,
    `llama.decode_positions`' pos_ok at these shapes."""
    llm = cfg.llm
    pos_ok = llama.decode_positions(
        llm, torch.full((1,), sp, device=DEVICE),
        torch.ones((1, sp), dtype=torch.int32, device=DEVICE),
        torch.zeros((1, sg), dtype=torch.bool, device=DEVICE), 0)[-1]
    route = "kernel" if pos_ok else "plain"
    taken = ("K4" if pos_ok else
             "decode_attend_plain with the position-aware mask and bias")
    print(f"route: decode attention over Sp={sp}, Sg={sg} -> {taken} "
          f"(pos_ok = {pos_ok} for {llm.position_embedding}, window "
          f"{llm.sliding_window}, Sp + Sg = {sp + sg}): the reference's rule "
          "pos_ok, halva_tpu/models/llama.py:896-900, from the config and "
          "the cache shapes (the decode kernels carry no bias and no window)")
    return route


def family_logits(params, cfg, inputs, tokens, impl, noise=None):
    """First-token logits and COMPARE_STEPS decode-step logits fed `tokens`,
    on path `impl`; with `noise`, the spliced prompt embeddings and the
    decode tokens' embeddings are perturbed by 2^-7 N(0, 1) relative."""
    ids, images, lens = inputs
    b, s = ids.shape

    seg = (torch.arange(s, device=DEVICE)[None, :] < lens[:, None]).int()
    sp = llava.splice_image_tokens(
        params, cfg, ids, llava.encode_images(params, cfg, images), seg)
    hidden, pc = llama.prefill(params["llm"], cfg.llm,
                               perturbed(sp.embeds, noise), sp.segment_ids,
                               sp.positions, attn_impl=impl)
    slen = sp.segment_ids.sum(dim=1)
    last = hidden[torch.arange(b, device=DEVICE), (slen - 1).long()][:, None]
    logits = [llama.lm_logits(params["llm"], cfg.llm, last)[:, 0]]
    gen_cache = init_gen_cache_like(cfg.llm, b, NEW_TOKENS, pc)
    for step in range(COMPARE_STEPS):
        emb = perturbed(llama.embed(params["llm"], tokens[:, step, None]),
                        noise)
        lg, gen_cache = llama.decode_step(
            params["llm"], cfg.llm, emb, slen + step, pc, sp.segment_ids,
            gen_cache, step, attn_impl=impl)
        logits.append(lg)
    return torch.stack(logits)  # (1 + steps, B, V)


def floor_check(runs: dict, what: str) -> None:
    """Kernel path against plain path, position by position, within
    TRAIN_FLOOR_FACTOR of the noise floor measured beside it."""
    finite = all(bool(torch.isfinite(r).all()) for r in runs.values())
    n = runs["plain"].shape[0]
    err = [rel_err(runs["auto"][i], runs["plain"][i]) for i in range(n)]
    floor = [rel_err(runs["floor"][i], runs["plain"][i]) for i in range(n)]
    agree = float((runs["auto"].argmax(-1) == runs["plain"].argmax(-1))
                  .float().mean())
    ok = finite and all(e <= TRAIN_FLOOR_FACTOR * f
                        for e, f in zip(err, floor))
    print(f"{what} kernel vs plain path: logits rel err "
          + ", ".join(f"{e:.3e}" for e in err)
          + "; noise floor (plain vs plain with the embeddings x (1 + 2^-7 "
          "N(0,1))) " + ", ".join(f"{e:.3e}" for e in floor)
          + f"; bound {TRAIN_FLOOR_FACTOR:.3f} x floor; argmax agreement "
          f"{agree:.3f}; logits finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel path disagrees with the plain "
                             "path")


def decode_step_ms(params, cfg, pc, pseg, positions, token, impl) -> float:
    """Device ms of one decode step at gen slot 8 on path `impl`, replayed
    from a CUDA graph (no host time)."""
    at = 8
    gen_cache = init_gen_cache_like(cfg.llm, token.shape[0], NEW_TOKENS, pc)
    emb = llama.embed(params["llm"], token)
    return device_ms(lambda: llama.decode_step(
        params["llm"], cfg.llm, emb, positions + at, pc, pseg, gen_cache, at,
        attn_impl=impl))


def run_family_serving(params, cfg, name: str, kernels: dict,
                       prefill_kernel: str, decode_kernel) -> None:
    """Greedy decode of the 4 requests on `cfg`'s bf16 tree: the main path
    with its launches asserted (K1 in `prefill_kernel`'s mode once per
    layer; `decode_kernel` once per layer and step, or no decode kernel at
    all where the reference's rule takes the plain attention), then
    first-token and decode-step logits against the plain path."""
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]
    route = decode_route(cfg, max(PROMPT_LENS), 128)
    if (route == "kernel") != (decode_kernel is not None):
        raise AssertionError(f"{name}: unexpected decode route {route}")
    with torch.inference_mode():
        generate_greedy(params, cfg, *inputs, max_new_tokens=2, eos_id=-1)
        _, prefill_s, _ = timed_run(lambda: _prefill_impl(params, cfg,
                                                          *inputs))
        torch.cuda.reset_peak_memory_stats()
        (tokens, num), total_s, launches = timed_run(lambda: generate_greedy(
            params, cfg, *inputs, max_new_tokens=NEW_TOKENS, eos_id=-1))
        peak = torch.cuda.max_memory_allocated()
    want = {prefill_kernel: layers}
    if decode_kernel is not None:
        want[decode_kernel] = layers * NEW_TOKENS
    expect_launches(launches, want, f"{name} main run")
    record(kernels, launches, *want)
    ok = in_vocab(tokens, cfg) and bool((num == NEW_TOKENS).all())
    decode_s = total_s - prefill_s
    print(f"{name} main path: tokens {tuple(tokens.shape)} in [0, "
          f"{cfg.llm.vocab_size}); prefill {prefill_s * 1e3:.2f} ms (B={b}, "
          f"{max(PROMPT_LENS)} spliced tokens), decode "
          f"{decode_s / NEW_TOKENS * 1e3:.3f} ms/step on the "
          f"{'kernel' if decode_kernel else 'plain position-aware'} route, "
          f"{b * NEW_TOKENS / decode_s:.1f} decode tokens/s, "
          f"{b * NEW_TOKENS / total_s:.1f} tokens/s end to end "
          f"({total_s:.3f} s), peak memory {peak / 2**30:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: generated tokens out of range")
    with torch.inference_mode():
        _, _, slen, pc, pseg = _prefill_impl(params, cfg, *inputs)
        step_ms = {impl: decode_step_ms(params, cfg, pc, pseg, slen,
                                        tokens[:, 8, None], impl)
                   for impl in ("auto", "plain")}
        del pc
    print(f"{name} decode step device time (a CUDA graph, gen slot 8, B={b}):"
          f" {step_ms['auto']:.3f} ms on the "
          f"{'K4' if decode_kernel else 'plain position-aware'} route, "
          f"{step_ms['plain']:.3f} ms with attn_impl='plain' "
          f"({'decode_attend_plain without a bias' if decode_kernel else 'the same route'})"
          f"; {decode_s / NEW_TOKENS * 1e3:.3f} ms on the host clock in the "
          f"main run: the device idles "
          f"{1 - step_ms['auto'] / (decode_s / NEW_TOKENS * 1e3):.1%} of a "
          "step")
    noise = torch.Generator(device=DEVICE).manual_seed(6)
    with torch.inference_mode():
        runs = {"auto": family_logits(params, cfg, inputs, tokens, "auto"),
                "plain": family_logits(params, cfg, inputs, tokens, "plain"),
                "floor": family_logits(params, cfg, inputs, tokens, "plain",
                                       noise)}
    floor_check(runs, f"{name} first token and decode steps 0-"
                f"{COMPARE_STEPS - 1}:")


def run_long_row(params, cfg, kernels: dict) -> None:
    """One text-only row of LONG_ROW tokens through llama.prefill and
    decode_step on Mistral's tree: past the window, so K1's window mode
    masks and skips key tiles, and decode takes the position-aware plain
    attention (no decode kernel launches). Last-token and decode-step
    logits against the plain path, beside the noise floor."""
    llm, layers = cfg.llm, cfg.llm.num_layers
    rng = np.random.RandomState(7)
    ids = torch.from_numpy(rng.randint(5, 30000, (1, LONG_ROW + LONG_STEPS))
                           .astype(np.int32)).to(DEVICE)
    seg = torch.ones((1, LONG_ROW), dtype=torch.int32, device=DEVICE)
    pos = torch.arange(LONG_ROW, dtype=torch.int32, device=DEVICE)[None]
    route = decode_route(cfg, LONG_ROW, 128)
    if route != "plain":
        raise AssertionError("the long row should outgrow the window")

    def run(impl, noise=None):
        t0 = time.perf_counter()
        emb = perturbed(llama.embed(params["llm"], ids[:, :LONG_ROW]), noise)
        hidden, pc = llama.prefill(params["llm"], llm, emb, seg, pos,
                                   attn_impl=impl)
        logits = [llama.lm_logits(params["llm"], llm, hidden[:, -1:])[:, 0]]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        gen_cache = init_gen_cache_like(llm, 1, LONG_STEPS, pc)
        for step in range(LONG_STEPS):
            emb = perturbed(llama.embed(params["llm"],
                                        ids[:, LONG_ROW + step, None]), noise)
            lg, gen_cache = llama.decode_step(
                params["llm"], llm, emb,
                torch.full((1,), LONG_ROW + step, device=DEVICE), pc, seg,
                gen_cache, step, attn_impl=impl)
            logits.append(lg)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0 - prefill_s) / LONG_STEPS
        return torch.stack(logits), prefill_s, step_s

    with torch.inference_mode():
        run("auto")  # warm-up at this shape, not counted
        torch.cuda.synchronize()
        _kernels.reset_launches()
        auto, prefill_s, step_s = run("auto")
        launches = dict(_kernels.launches)
        expect_launches(launches, {"flash_fwd_window": layers},
                        f"long Mistral row ({LONG_ROW} tokens, "
                        f"{LONG_STEPS} decode steps: no decode kernel)")
        emb = llama.embed(params["llm"], ids[:, :LONG_ROW])
        _, pc = llama.prefill(params["llm"], llm, emb, seg, pos)
        dev_ms = decode_step_ms(
            params, cfg, pc, seg,
            torch.full((1,), LONG_ROW, device=DEVICE), ids[:, LONG_ROW, None],
            "auto")
        del pc, emb
        print(f"long row main path: prefill {prefill_s * 1e3:.1f} ms for "
              f"{LONG_ROW} tokens (window {llm.sliding_window}), decode "
              f"{step_s * 1e3:.2f} ms/step on the plain position-aware route "
              f"on the host clock, {dev_ms:.3f} ms of device time (a CUDA "
              "graph, gen slot 8)")
        noise = torch.Generator(device=DEVICE).manual_seed(8)
        runs = {"auto": auto, "plain": run("plain")[0],
                "floor": run("plain", noise)[0]}
    floor_check(runs, f"long row last token and decode steps 0-"
                f"{LONG_STEPS - 1}:")


def run_mistral(kernels: dict) -> None:
    """Mistral-7B under CLIP ViT-L/14-336 (VILA's llava_mistral): serving
    (K1 window mode, K4 at G=4), the long row, the train step (K1, K2, K3
    in window mode, GQA in K3's group sum), and a short int4g run with int4
    prompt KV (K6 and K4 int4 at Mistral's shapes)."""
    cfg, name = LLAVA_MISTRAL_7B, "mistral-7b"
    layers = cfg.llm.num_layers
    params = new_tree(cfg, f"{name} + CLIP ViT-L/14-336")
    run_family_serving(params, cfg, name, kernels, "flash_fwd_window",
                       "decode_attn")
    run_long_row(params, cfg, kernels)
    torch.cuda.empty_cache()
    run_train(params, kernels, cfg, f"{name} ", "_window",
              FAMILY_MICRO_STEPS, grad_accum=1)
    torch.cuda.empty_cache()
    q4 = quantize_int4g(params)
    del params
    torch.cuda.empty_cache()
    inputs = make_inputs(cfg)
    with torch.inference_mode():
        generate_greedy(q4, cfg, *inputs, max_new_tokens=1, eos_id=-1,
                        kv_quant="int4")  # warm-up, not counted
        (tok, num), secs, launches = timed_run(lambda: generate_greedy(
            q4, cfg, *inputs, max_new_tokens=SHORT_TOKENS, eos_id=-1,
            kv_quant="int4"))
    # K6 at N=1024 (wk, wv), N=14336 (gate, up) and K=14336 (down); K4 int4
    # at G=4
    expect_launches(launches, {
        "flash_fwd_window": layers,
        "decode_attn_kv4": layers * SHORT_TOKENS,
        "w4_gemv": 7 * layers * SHORT_TOKENS}, f"{name} int4g run")
    ok = in_vocab(tok, cfg) and bool((num == SHORT_TOKENS).all())
    print(f"{name} int4g run: {SHORT_TOKENS} tokens x {tok.shape[0]} rows in "
          f"{secs:.3f} s with its prefill {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} int4g tokens out of range")


def run_mpt(kernels: dict) -> None:
    """MPT-7B under CLIP ViT-L/14-336 (VILA's llava_mpt): serving (K1 ALiBi
    mode; decode through the plain attention with the bias) and the train
    step (K1, K2, K3 in ALiBi mode)."""
    cfg, name = LLAVA_MPT_7B, "mpt-7b"
    params = new_tree(cfg, f"{name} + CLIP ViT-L/14-336")
    run_family_serving(params, cfg, name, kernels, "flash_fwd_alibi", None)
    torch.cuda.empty_cache()
    run_train(params, kernels, cfg, f"{name} ", "_alibi", FAMILY_MICRO_STEPS,
              grad_accum=1)


def flash_checks(gen: torch.Generator) -> list:
    """K1, K2 and K3 against their plain versions, base mode then the modes:
    their rows of the `kernels` line."""
    base = [check_flash(gen), *check_flash_bwd(gen)]
    check_flash_long(gen)
    check_flash_repeat(gen)
    check_flash_bwd_repeat(gen)
    return base + check_flash_modes(gen, {k["name"]: k for k in base})


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
    if sys.argv[1:] == ["--flash-only"]:
        print(json.dumps({"flash_kernels": flash_checks(gen)}))
        return
    if sys.argv[1:] == ["--decode-only"]:
        print(json.dumps({"decode_kernels": decode_checks(gen)}))
        return
    if sys.argv[1:] == ["--fold-only"]:
        print(json.dumps({"fold_kernels": check_fold(gen)}))
        return
    if sys.argv[1:] == ["--gemm-only"]:
        checked = [check_w4_gemm(gen), check_int8_matmul(gen)]
        gemm_summary(checked)
        k6_rows_table(gen)
        gemm_plan_sweep(gen)
        q4 = quantize_int4g(new_tree(LLAVA_V15_7B, "llava-v1.5-7b"))
        run_batch80(q4, LLAVA_V15_7B)
        keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "library_ms")
        print(json.dumps({"gemm_kernels": [{k: kern[k] for k in keys}
                                           for kern in checked]}))
        return
    quant_only = sys.argv[1:] == ["--quant-only"]
    if sys.argv[1:] and not quant_only:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    checked = [check_w4_gemm(gen), check_int8_matmul(gen)]
    gemm_summary(checked)
    if not quant_only:
        checked = flash_checks(gen) + [
            check_decode(gen), *check_decode_quant(gen), *check_fold(gen),
            check_w4(gen)] + checked
    kernels = {k["name"]: k for k in checked}
    if quant_only:  # the other kernels' launches are counted, not kept
        kernels = collections.defaultdict(dict, kernels)
    print(f"route: attn_impl='auto' at head dim {CFG.llm.head_size} -> "
          f"{kernel_route('auto', CFG.llm.head_size)}, at head dim 64 -> "
          f"{kernel_route('auto', 64)} (ops/attention.kernel_route, from the "
          "config alone, on either device: K1-K5 and the packed-int4 decode "
          "step take head dim 128 only; a caller who names 'kernel' still "
          "gets the wrappers' ValueError)")
    if quant_only:
        params = new_tree(LLAVA_V15_7B, "llava-v1.5-7b")
    else:
        params = run_bf16(kernels)
        run_beam_spec_bf16(params, kernels)
        run_train(params, kernels)
    torch.cuda.empty_cache()
    # the quantized trees, each made on the card from the bf16 tree, which
    # is freed once the last of them exists (no_grad, not inference_mode:
    # the train step saves these leaves for its backward)
    with torch.no_grad():
        t0 = time.perf_counter()
        q8 = quant.quantize_params(params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nf4 = quant.quantize_params(params, bits=4)
        torch.cuda.synchronize()
        print(f"int8 tree: quant.quantize_params on the card in "
              f"{t1 - t0:.2f} s, {tree_bytes(q8) / 1e9:.3f} GB; NF4 tree "
              f"(bits=4, one code index per uint8 byte, int8 embedding) in "
              f"{time.perf_counter() - t1:.2f} s, "
              f"{tree_bytes(nf4) / 1e9:.3f} GB")
    q4 = quantize_int4g(params)
    del params  # the bf16 tree is freed here
    torch.cuda.empty_cache()
    run_int8_serving(q8, kernels)
    run_train_quant(q8, kernels, "int8", W8A8_FLOOR_FACTOR)
    del q8
    torch.cuda.empty_cache()
    run_train_quant(nf4, kernels, "NF4", TRAIN_FLOOR_FACTOR)
    del nf4
    torch.cuda.empty_cache()
    print("route: dense on kernel_q4p at prefill and train M -> dequantize "
          "+ torch.matmul (K7 is measured beside it in check_w4_gemm and "
          "routed only where it wins); kernel_q4 -> nf4_dense; kernel_q -> "
          "int8_dense (W8A8 on)")
    run_train_quant(q4, kernels, "int4g", W8A8_FLOOR_FACTOR)
    greedy_tokens = run_int4g(q4, kernels)
    run_beam_spec_int4g(q4, kernels, greedy_tokens)
    del q4
    torch.cuda.empty_cache()
    if not quant_only:
        run_mistral(kernels)
        torch.cuda.empty_cache()
        run_mpt(kernels)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "halva_tpu"))
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    print("imports: neither jax nor any module of the JAX package")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    idle = [kern["name"] for kern in checked if not kern.get("launches")]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in checked]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
