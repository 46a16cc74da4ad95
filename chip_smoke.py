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
on the first FAMILY_LAYERS (16) of their 32 layers, each from its own
random bf16 tree: Mistral-7B (GQA 32 over 8
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

The eval entry point: every decode loop runs from CUDA graphs
(ops/graph_loop.py), so the runs above already replay their steps; on the
bf16 and the int4g trees each loop (greedy, 4 beams, verify draft_k 4 and
8, and on int4g greedy at batch 80) is then held against its eager body
on the card, token for token and launch for launch, with its host clock
and device time per step, idle share and capture time. The loader
(models/builder.py) loads a random llava-v1.5-7b checkpoint and rank-128
PEFT adapter that the smoke writes under build/ from the bf16 tree, int4g
cold and warm from the tree cache, each bitwise equal to the merge
quantized in memory, and `python -m halva_tpu_torch.bench` runs in its own
process and prints its JSON line.

The scripts tail: `python -m halva_tpu_torch.convert_checkpoint` runs in
its own process on the loader's shards, and its save_params dir reads back
through train/checkpoint.load_params equal to the bf16 tree bit for bit;
halva_tpu_torch.chat's device half (ChatSession, batch 1) answers two
questions greedily at the chat's 512 tokens and one with 4 beams on the
bf16 tree, and one greedily on each route of the int8 tree (W8A8, the
CLI's default, and weight-only: K8 at one row), each token for token
against generate_greedy / generate_beam, with the time to the first token
and host and device ms a token; the eval suite's device half drains three
batches of 80 requests from the runner's own builders (captions,
POPE-shaped yes/no questions, HallusionBench-shaped rows with 20 text-only)
on the int4g tree with int4 prompt KV, prints each batch's host wall time
and prefill share and a labelled projection of every benchmark's time at
its public size; the `_b1` rows hold K1, K4 (bf16 and its beam
mode) and K8 at the chat's batch of 1.

The train entry point (train/run.py, after the loader, on the bf16 tree):
the tree written by train/checkpoint.save_params is the base of
`train.run.train` at full width on the tree's first CLI_LAYERS (8) layers,
under a preset of that depth (4 micro-steps of 2 pre-tokenized
samples at the recipe's shapes, grad_accum 2, LoRA r=128, a checkpoint
every 2 steps, the component dirs at the end), with its K1/K2/K3 launches
per micro-step those of the train step at that depth, its host clock per
micro-step
beside that phase's device time, and each checkpoint save's seconds and
bytes; a second run stopped at step 2 and resumed equals it at steps 3-4;
the component checkpoint, loaded by models/builder.py, is merge_lora of
the trained tree bit for bit and decodes the same 8 greedy tokens (K4).

Packed DPA and the 8-bit Adam moments (after the train entry point, on the
same save_params dir): samples of 96-512 text tokens (mean 256, from a
seed) packed by train/pack.PackedDPABatcher into 2 pn rows and 1 ref row
of 2,624 tokens (3 samples a step, 3 documents in every pn row, positions
restarting per document); K1, K2 and K3 against their plain versions on
the batcher's own segment ids, timed beside their bounds and SDPA with the
packed mask; one packed micro-step (llava.forward_packed, the packed loss)
against the unpacked micro-step on the same samples within 4/3 of a noise
floor; 3 packed micro-steps with 8-bit moments, their 160 K1 + 64 K2 + 64
K3 launches each added to the `kernels` line, and their time beside the
unpacked micro-step's on the same samples as samples/s; 8 updates of
train/optim8bit on the 7B LoRA tree against fp32 moments, its state bytes
and update time beside torch.optim.AdamW's; the train CLI with
`--pack true --optim adamw8bit`, 4 micro-steps, and a run stopped at 2
and resumed equal to it.

The eval path's decode variants, on the int4g tree with int4 prompt KV
(after its graph loops; briefly on the bf16 tree, where temperature 0 is
greedy): nucleus sampling (`generate`, temperature 0.7, top_p 0.9) at batch
80 over 128 tokens from CUDA graphs, its graph loop against its eager body
token for token with every eager draw inside its step's nucleus, a seed
that repeats and one that differs, temperature 0 against generate_greedy,
the sampled step's device time beside the greedy step's, and the sampler
alone on full-vocab logits against the float64 filtered softmax by a
chi-square test; then the continuous-batching engine (ops/continuous.py)
on bench_continuous's workload (160 of its 240 requests with CHAIR-like
budgets, batch 80, cap 128) at chunk 16, its graph run against its eager
run from the same global step token for token, every request against the
drain with each
divergence at a drain top-two margin within a measured bf16 noise floor,
imgs/s against the drain's, and one decode step with the engine's ring
mask on K4 against the plain path. Their K1, K4 and K7 launches are added
to the `kernels` line.

Gemma-2B at head dim 256 (after MPT): the 256 instances of K1 (Gemma's
prefill, B=4, H=8 over KVH=1), K2 and K3 (the train step's pn rows, B=4 of
1087 tokens, also against their tile walks; the packed batcher's rows; the
window mode; bitwise repeats and graph replays), K4 (bf16, int8/int8,
int4/int8 and its beam mode on bf16 and int4 caches, Sg=128) and K5 (the
per-beam and the shared stage, bf16 and int4 caches) are held against
their plain versions and timed beside their bounds, SDPA and their plans;
then VILA's llava_gemma (Gemma-2B under CLIP ViT-L/14-336) at full width
and depth from a seeded random bf16 tree and its int4g tree with int4
prompt KV: greedy decode of the 4 requests (18 K1 a prefill, 18 K4 a
token, 126 K6 an int4g token) against the plain route within 4/3 of a
noise floor, 4 beams on the route "auto" takes and a short run on the
other, draft_k-4 speculative decode (K7 at B*K rows), a short int8-KV run,
each graph loop against its eager body, and each step's device time on the
kernel route beside the plain route's; on the bf16 tree the DPA train step
(the llava recipe: 4 micro-steps, 2 updates, 90 K1, 36 K2 and 36 K3 at 256
a micro-step, one micro-step against the plain route within 4/3 of a noise
floor) and its packed step (2 micro-steps on the packed batcher's rows,
one against the unpacked step on the same samples). The 256 instances are
rows of their own in the `kernels` line (`*_d256`).

VILA-1.5-13B at 384 px (after Gemma): K1 at its prefill (4 rows of 228-243
spliced tokens: 196 image tokens each, H=KVH=40), K1, K2 and K3 at its
train step's pn rows (4 x 707 tokens), K4 (bf16 and int4 prompt KV, H=40;
one query a row and its 4-beam mode), K5 (per-beam and shared gen stages,
4 queries an item) over the same caches, and K6 / K7 at its 13B decode
matmuls (wq, gate/up, down; 4, 16 and 80 rows) are held against their plain versions and timed beside their bounds
and library calls (rows `*_vila13b` of the `kernels` line); then the
VILA_13B_384 preset at full width and depth (SigLIP-so400m/14-384 at layer
-2, mlp_downsample with the 27 x 27 grid padded to 28 x 28, Llama-13B) from
a seeded random bf16 tree and its int4g tree with int4 prompt KV: greedy
decode of the 4 requests (40 K1 a prefill, 40 K4 a token, 280 K6 an int4g
token) against the plain route within 4/3 of a noise floor, 4 beams, draft_k
4 speculative decode, each graph loop against its eager body, each step's
device time beside the plain route's; on the bf16 tree a multi-image
forward (2 image slots a row, one row with 1 image), S2 on its tower at
scales (384, 768), and the DPA step by train/vila.py's recipe (LoRA r=128,
the projector trained whole, loss alpha 0.2: 4 micro-steps, 200 K1, 80 K2
and 80 K3 a micro-step, updates to LoRA and projector leaves only, one
micro-step against the plain route within 4/3 of a noise floor in
alignment, KL, LoRA grads and projector grads); last InternViT-6B-448 and
RADIO ViT-H/16-432 at full width on one image each.
The device mesh (parallel/, after the int4g beam and verify runs): K6 at a
tp=2 shard's decode matmuls (gate/up N=5504, down K=5504, 4 rows), K7 at 16
rows, K4 at 16 local heads and K1-K3 on the last of 4 context-parallel
shards of a 4,096-token row are held against their plain versions and
timed (rows `*_tp2`, `*_cp4096`); then (a) a world of one over NCCL, mesh
{1, 1}: generate(mesh=) gives the int4g main run's tokens exactly from a
captured loop, and BatchedGenerator(mesh=) the meshless texts; (b) two
ranks spawned on the one card, joined by gloo over CUDA tensors, each
handed its contiguous shards of the tp=2-packed int4g tree (quantized from
the bf16 tree before it is freed) and the int4g tree by CUDA IPC: manual TP
{data 1, model 2} (prefill logits against the single-device int4g logits,
greedy tokens beside the main run's, a batch-16 run on K7), data
parallelism {data 2, model 1} (each rank's rows token for token against
the one-device program on them, loops captured: no collective in the
body), context_parallel_attention over {seq 2} against the full call; each
rank prints its launches and imports neither JAX nor the JAX package; (c)
the 4 shard bodies of a 4,096-token row one after another with their
q_offsets, forward and backward, against the full call.
The training half of the mesh: (a) right after the bf16 train phase, a
world of one over NCCL, mesh {1, 1}: two micro-steps of the bf16 7B tree at
full width and depth through init_train_state(mesh=) and
dpa_step_fns(mesh=) equal the train phase's first two meshless micro-steps
bit for bit (metrics, LoRA leaves, AdamW moments); (b) in the two-rank
spawn above, on the bf16 tree's first MESH_TRAIN_LAYERS layers at full
width (handed over by CUDA IPC; gloo carries every gathered layer through
host memory) with the train recipe (LoRA r=128 with a small
nonzero lora_b, remat, loss_chunk 256, 2 rows of 1,087 tokens) and a
constant lr of MESH_TRAIN_LR: one unpacked AdamW micro-step on {data 2,
model 1} (FSDP) and on {data 1, model 2} (TP, gather-at-use), one packed
micro-step on {data 2} whose batch holds a sample with its positive and
negative documents on different ranks, each against the one-device step on
the same tree and batch within TRAIN_FLOOR_FACTOR of a noise floor (loss,
alignment, KL, the LoRA leaves' update); each rank prints its K1/K2/K3
launches and peak memory.
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
and at batch 80, the route "auto" takes), then times K5 against K4's beam
mode with int8 and int4 prompt caches at 4, 8, 16, 32 and 80 items beside
the route "auto" takes at each, and prints their rows.

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

    python3 chip_smoke.py --train-cli-only

runs only the train step (no plain-path comparison) for its time per
micro-step, then the train entry point's phase and the packed-train phase,
on a fresh random tree.

    python3 chip_smoke.py --pack-only

runs only the packed-train phase above (its K1-K3 rows, the packed against
the unpacked micro-step, the launches and times, 8-bit Adam, the packed
train CLI) on a fresh random tree, with its own save_params dir, and prints
its rows.

    python3 chip_smoke.py --gemma-only

runs only the Gemma-2B phase above, after the head-dim-128 checks of K1
and K4 (their times in the same call), and prints its rows.

    python3 chip_smoke.py --gemma-train-only

runs only K1's, K2's and K3's head-dim-256 checks and the Gemma-2B train
step (unpacked and packed) on a fresh random tree, and prints their rows.

    python3 chip_smoke.py --vila-only

runs only the VILA-13B/384 phase above after its kernel checks, and prints
its rows.

    python3 chip_smoke.py --mesh-only

runs only the mesh phase above after its kernel checks, on a fresh random
tree, and prints its rows.

    python3 chip_smoke.py --serve-variants-only

runs only the decode variants' phases (sampling, the sampler's frequencies,
continuous batching) on a fresh random tree quantized to int4g, and prints
their launches.

    python3 chip_smoke.py --recipe-peak-only

builds the kernels and measures only the card's memory under the 13B
launch scripts' train step on one card: two DPA micro-steps of
llava-v1.5-13b at 2 x 2,048 text tokens and of VILA-13B/384 at 2 x 4,096
(scripts/torch_halva_13b.sh and torch_halva_vila_13b.sh, their flags as
train/run.py reads them), at full width and depth; not part of the run
with no arguments.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import functools
import importlib
import itertools
import json
import os
import queue as queue_lib
import shutil
import socket
import statistics
import subprocess
import sys
import time
import zlib
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from halva_tpu_torch import _kernels, tree
from halva_tpu_torch.chat import ChatSession
from halva_tpu_torch.config import (
    CLIP_VIT_L_336,
    GEMMA_2B,
    INTERNVIT_6B_448,
    LLAVA_V15_7B,
    MISTRAL_7B,
    MPT_7B,
    RADIO_VIT_H_432,
    PRESETS,
    VILA_13B_384,
    LlavaConfig,
)
from halva_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from halva_tpu_torch.conversation import get_template
from halva_tpu_torch.mm_utils import processor_for_vision
from halva_tpu_torch.models import llama, llava, s2, vit
from halva_tpu_torch.models.llava import LlavaModel
from halva_tpu_torch.ops import int8_matmul as int8_ops
from halva_tpu_torch.ops import quant, w4_matmul
from halva_tpu_torch.ops.attention import (
    alibi_in_kernel,
    attention,
    causal_alibi_bias,
    head_dim_suffix,
    kernel_route,
    make_attention_mask,
)
from halva_tpu_torch.ops.beam import (_beam_decode_impl, beam_loop,
                                      generate_beam, init_beam_state,
                                      penalty_table, reorder_gen_cache,
                                      select_step)
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
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_bwd_tiled_plain,
    flash_attention_delta,
    flash_attention_fwd,
    flash_attention_plain,
)
from halva_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from halva_tpu_torch.models.builder import load_pretrained_model
from halva_tpu_torch import bench_continuous
from halva_tpu_torch.ops import generate as generate_mod
from halva_tpu_torch.ops.continuous import ContinuousEngine, Request, _ring_valid
from halva_tpu_torch.ops.generate import (
    FIRST_STEP,
    _decode_impl,
    _prefill_impl,
    decode_loop,
    generate,
    generate_greedy,
    init_gen_cache_like,
    nucleus_logits,
)
from halva_tpu_torch.ops.speculative import (
    _spec_decode_impl,
    generate_speculative,
    spec_loop,
)
from halva_tpu_torch.ops.w4_matmul import (
    dequantize_int4,
    quantize_params_int4,
    w4_dense_stacked,
    w4_dense_stacked_plain,
    w4_gemm,
    w4_gemm_plain,
)
from halva_tpu_torch.evals import runner as runner_mod
from halva_tpu_torch.parallel import partition
from halva_tpu_torch.parallel.context import (
    context_parallel_attention,
    sequential_cp_attention,
)
from halva_tpu_torch.parallel.mesh import axes_mesh, make_mesh, mesh_shape
from halva_tpu_torch.train import checkpoint as ckpt_lib
from halva_tpu_torch.train import optim8bit
from halva_tpu_torch.train.data import collate
from halva_tpu_torch.train.lora import add_lora
from halva_tpu_torch.train.pack import PackedDPABatcher
from halva_tpu_torch.train.vila import VILA_13B_RECIPE
from halva_tpu_torch.train.trainer import (
    TrainConfig,
    dpa_step_fns,
    init_train_state,
    packed_dpa_step_fns,
)

CFG = LLAVA_V15_7B  # the first train phase's model
# VILA's llava_mistral and llava_mpt compositions at 7B
# at full width on the first FAMILY_LAYERS of their 32 layers (the smoke's
# time limit)
FAMILY_LAYERS = 16


def at_depth(cfg: LlavaConfig, layers: int) -> LlavaConfig:
    """`cfg` with its LLM cut to `layers` layers, the widths unchanged."""
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, num_layers=layers))


LLAVA_MISTRAL_7B = at_depth(LlavaConfig(llm=MISTRAL_7B, vision=CLIP_VIT_L_336),
                            FAMILY_LAYERS)
LLAVA_MPT_7B = at_depth(LlavaConfig(llm=MPT_7B, vision=CLIP_VIT_L_336),
                        FAMILY_LAYERS)
# and VILA's llava_gemma: Gemma-2B (head dim 256, 8 heads over 1 kv head)
LLAVA_GEMMA_2B = LlavaConfig(llm=GEMMA_2B, vision=CLIP_VIT_L_336)
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


def spliced_lens(cfg) -> tuple:
    """The 4 requests' spliced lengths under `cfg`: PROMPT_LENS for every
    config with CLIP-336's 576 image tokens."""
    return tuple(n + cfg.num_image_tokens - 1 for n in TEXT_LENS)

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
# replays behind a whole decode step's time on the plain route (the plain
# int4 matmuls dequantize every call: 342 ms a VILA-13B step): reduced from
# device_ms's 20 for the smoke's time limit
PLAIN_STEP_ITERS = 3
# the card's published peaks (H100 SXM data sheet), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


_CLOCK = [time.perf_counter()] * 2  # the smoke's start, the last mark


def clock(stage: str) -> None:
    """The smoke's clock on stderr: seconds since its start and the stage
    just ended."""
    now = time.perf_counter()
    print(f"[smoke +{now - _CLOCK[0]:7.1f}s] {stage}: "
          f"{now - _CLOCK[1]:.1f} s", file=sys.stderr, flush=True)
    _CLOCK[1] = now


@functools.lru_cache(maxsize=None)
def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi prints them, read
    once: neither changes while the smoke runs."""
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


def k1_plan(b: int, sq: int, skv: int, h: int, d: int = 128) -> str:
    """K1's launch plan as the wrapper picks it (an older tree, run for an
    A/B comparison, has none to report)."""
    plan_of = getattr(flash_ops, "flash_fwd_plan", None)
    if plan_of is None:
        return "plan: not reported by this tree"
    plan = plan_of(b, sq, skv, h) if d == 128 else plan_of(b, sq, skv, h,
                                                            d=d)
    return (f"plan: {plan.bq}-row blocks, {plan.bk}-key tiles, "
            f"{plan.stages} stages, {plan.blocks} blocks")


def bwd_plan(b: int, sq: int, skv: int, h: int, kvh: int,
             d: int = 128) -> str:
    """K2's and K3's launch plans as the wrappers pick them (an older tree,
    run for an A/B comparison, has none to report)."""
    plan_of = getattr(flash_ops, "flash_bwd_plan", None)
    if plan_of is None:
        return "K2/K3 plan: not reported by this tree"
    plan = plan_of(b, sq, skv, h, kvh, sms=sm_count(torch.device("cuda")),
                   d=d)
    return (f"K2 plan: {plan.dq.rows}-row blocks, {plan.dq.tile}-key tiles, "
            f"{plan.dq.stages} stages, {plan.dq.blocks} blocks, "
            f"{plan.dq.order}, warpgroups split by {plan.dq.split}; K3 plan: "
            f"{plan.dkv.rows}-key blocks, {plan.dkv.tile}-query tiles, "
            f"{plan.dkv.stages} stages, {plan.dkv.blocks} blocks, "
            f"{plan.dkv.order}, warpgroups split by {plan.dkv.split}")


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
    plain_ms = device_ms(lambda: flash_attention_plain(q, k, v, seg, seg),
                         iters=5)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * h * d * n * (n + 1) / 2
    lim = bound(tensor_bytes(q, k, v, seg, o, lse), flops)
    print(f"flash_fwd one {n}-token row, causal, time: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA (causal) {lib_ms:.4f} ms, bound "
          f"{lim['bound_ms']:.4f} ms by "
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


def check_flash_bwd_repeat(gen: torch.Generator, h: int = 32, kvh: int = 8,
                           d: int = 128,
                           all_modes=({}, {"alibi": True},
                                      {"sliding_window": 256})) -> None:
    """K2 and K3 at the train shape (B=4 rows of 1087 tokens, padded; H
    query heads over KVH at head dim d) in each mode: two launches give the
    same bits (no float atomics; K3's GQA sum stays in the block), and a
    CUDA graph that captured both launches replays them on new inputs (new
    q, k, v, dO and the o, LSE and delta of K1 on them), bit for bit as
    eager launches on those inputs."""
    b, s = 4, TRAIN_SPLICED
    lens = (s, s - 7, s - 64, s - 301)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    seg = lengths_to_seg(lens, s, "cuda")
    for modes in all_modes:
        q, k, v, do = r(b, s, h, d), r(b, s, kvh, d), r(b, s, kvh, d), r(
            b, s, h, d)
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
              f"KVH={kvh} D={d}: bitwise repeat and CUDA-graph replay on new "
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
                    shard=None, timed=False, seg=None, d=128, tiled=False):
    """K1, K2 and K3 in one mode against their plain versions on random bf16
    inputs of B rows of S tokens at head dim d (padded to `lens`, two
    documents per row from `packed_at` on; or with the segment ids `seg`,
    (B, S) int32, as given). `shard` = (offset, rows): only that shard of
    the queries runs, with q_offset, against all keys, and is also held
    against the same rows of the full call. With `tiled`, K2 and K3 are also
    held against flash_attention_bwd_tiled_plain (their tile walks in torch
    ops). Returns {"fwd": .., "dq": .., "dkv": ..} of max_abs_err and, when
    timed, ms, plain_ms, library_ms and the bound on this run's live
    pairs."""
    dev = "cuda"

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q, k, v, do = r(b, s, h, d), r(b, s, kvh, d), r(b, s, kvh, d), r(
        b, s, h, d)
    if seg is None:
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
    if tiled:
        walk = flash_attention_bwd_tiled_plain(q, k, v, qseg, seg, o, lse,
                                               do, **kw)
        for name, g, w, lv in zip(("dq", "dk", "dv"), got[1:], walk,
                                  lives[1:]):
            g, w = g[lv].float(), w[lv].float()
            err, rel = max_abs(g, w), rel_err(g, w)
            limit = BWD_RTOL * (w.abs().max() + w.abs())
            ok = ok and bool((g - w).abs().le(limit).all()) and (
                rel <= BWD_REL)
            errs[name] = max(errs[name], err)
            line.append(f"{name} vs the tiled plain version {err:.3e} rel "
                        f"{rel:.3e}")
        del walk
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
          f"KVH={kvh} D={d} {kw}: max_abs_err " + ", ".join(line)
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
    print(f"flash modes {label} time ({k1_plan(b, q.shape[1], s, h, d)}; "
          f"{bwd_plan(b, q.shape[1], s, h, kvh, d)}): "
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
MODE_SUFFIX = {"bf16": "", "kv8": "_kv8", "kv4": "_kv4"}


def held(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel against plain version within KERNEL_ATOL / KERNEL_RTOL, and
    finite; prints the line and returns the max abs error."""
    torch.cuda.synchronize()
    ok = within(got, want) and bool(torch.isfinite(got).all())
    err, rel = max_abs(got, want), rel_err(got, want)
    print(f"{label}: max_abs_err {err:.3e} rel {rel:.3e} (limits "
          f"{KERNEL_ATOL} + {KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


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
    out = []

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
            worst = max(worst, held(
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
                    worst["fold"] = max(worst["fold"], held(
                        f"fold_attn{MODE_SUFFIX[mode]} {tag}",
                        fold(fold_attend_layer, li),
                        fold(fold_attend_plain, li)))
                want1 = decode_attend_plain(
                    q1, layer(pc, li), seg, layer(gc, li), gen_valid,
                    beam_k=k)
                worst["grid"] = max(worst["grid"], held(
                    f"decode_attn{MODE_SUFFIX[mode]}_beam {tag}", grid(li), want1))
            rows = k * h // kvh
            if with_k5:
                worst["fold"] = max(worst["fold"], forced_plans(
                    f"fold_attn{MODE_SUFFIX[mode]} {tag}",
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
                held(f"SDPA yardstick of fold_attn {tag}",
                        got.reshape(b, k, h, d), fold(fold_attend_plain, 0))
                lib_ms = device_ms(walk_sdpa) / layers
                del kcat, vcat
            lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            k5 = (f"K5 {ms:.4f} ms (plain {plain_ms:.4f}; "
                  f"{k5_plan(b, kvh, rows, h // kvh, sp, sg, False)}), "
                  if with_k5 else "")
            print(f"fold_attn{MODE_SUFFIX[mode]} {tag} time: {k5}K4 beam route "
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
            out.append({"name": "fold_attn" + MODE_SUFFIX[mode], "route": "cuda",
                        "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
                        "max_abs_err": worst["fold"], **fold_t})
        out.append({"name": f"decode_attn{MODE_SUFFIX[mode]}_beam", "route": "cuda",
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
        held(f"fold_attn{MODE_SUFFIX[mode]} {tag}", fold(0), want)
        held(f"decode_attn{MODE_SUFFIX[mode]}_beam {tag}",
                grid(0).reshape(want.shape), want)
        del want
        ms = device_ms(lambda: [fold(li) for li in range(layers80)])
        grid_ms = device_ms(lambda: [grid(li) for li in range(layers80)])
        prompt_mb = (b80 // len(PROMPT_LENS) * sum(PROMPT_LENS)
                     * _cache_row_bytes(mode, h, d, True) / 1e6)
        print(f"fold_attn{MODE_SUFFIX[mode]} at batch {b80} ({prompt_mb:.0f} MB of "
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
                worst = max(worst, held(
                    f"fold_attn{MODE_SUFFIX[mode]}_shared {tag}",
                    fold(fold_attend_layer, li), fold(fold_attend_plain, li)))
            worst = max(worst, forced_plans(
                f"fold_attn{MODE_SUFFIX[mode]}_shared {tag}",
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
            print(f"fold_attn{MODE_SUFFIX[mode]}_shared K={k} Sg={sg} time: kernel "
                  f"{ms:.4f} ms ({k5_plan(b, kvh, k, 1, sp, sg, True)}), "
                  f"plain {plain_ms:.4f} ms, SDPA over concatenated keys "
                  f"{lib}, bound {lim['bound_ms']:.4f} ms by "
                  f"{lim['bound_by']}")
            if k == BEAMS:
                timing = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, **lim}
            del pc, gc
        out.append({"name": f"fold_attn{MODE_SUFFIX[mode]}_shared", "route": "cuda",
                    "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
                    "max_abs_err": worst, **timing})
    return out


BEAM_SWEEP_ITEMS = (4, 8, 16, 32, 80)
BEAM_SWEEP_BYTES = 200e6  # prompt cache a timing walks: 4x the L2


def beam_route_sweep(gen: torch.Generator) -> None:
    """K5 against K4's beam mode with int8 and int4 prompt caches at 4 to 80
    items (4 beams, H=KVH=32, Sp=623, int8 gen cache of 128 slots), each
    timed over enough layers that the caches walked outgrow the L2, beside
    the route `auto_beam_route` takes (its 25 MB rule): where the rule
    switches against where the times cross. Printed only."""
    k, h, d, sp, sg, dev = BEAMS, 32, 128, 623, 128, "cuda"

    def layer(t, li):
        return {key: v[li] for key, v in t.items()}

    for mode in ("kv8", "kv4"):
        rows = []
        for items in BEAM_SWEEP_ITEMS:
            seg = lengths_to_seg(PROMPT_LENS * (items // len(PROMPT_LENS)),
                                 sp, dev)
            steps = torch.randint(0, sg, (items * k,), generator=gen,
                                  device=dev)
            gen_valid = torch.arange(sg, device=dev)[None, :] <= steps[:, None]
            q = torch.randn(items, k, h, d, generator=gen,
                            device=dev).bfloat16()
            q1 = q.reshape(items * k, 1, h, d)
            pc, gc = _fold_caches(gen, mode, 1, items, items * k, h, sp, sg,
                                  d)
            per_layer = sum(t.numel() * t.element_size() for t in pc.values())
            layers = min(32, max(2, -(-int(BEAM_SWEEP_BYTES) // per_layer)))
            del pc, gc
            pc, gc = _fold_caches(gen, mode, layers, items, items * k, h, sp,
                                  sg, d)

            def fold(li):
                return fold_attend_layer(q, layer(pc, li), seg, layer(gc, li),
                                         gen_valid, fold_k=k)

            def grid(li):
                return decode_attend_layer(q1, layer(pc, li), seg,
                                           layer(gc, li), gen_valid,
                                           beam_k=k, beam_route="grid")

            fold_ms = device_ms(lambda: [fold(li) for li in range(layers)])
            grid_ms = device_ms(lambda: [grid(li) for li in range(layers)])
            route = auto_beam_route(layer(pc, 0), seg, k)
            rows.append((items, per_layer / 1e6, fold_ms / layers,
                         grid_ms / layers, route))
            del pc, gc
            torch.cuda.empty_cache()
        faster = ["fold" if f < g else "grid" for _, _, f, g, _ in rows]
        cross = next((r[0] for r, w in zip(rows, faster) if w == "fold"),
                     None)
        switch = next((r[0] for r in rows if r[4] == "fold"), None)
        agree = sum(r[4] == w for r, w in zip(rows, faster))
        print(f"beam route sweep {mode} ({gpu_line()}): "
              + "; ".join(f"{n} items ({mb:.1f} MB a layer): K5 {f:.4f} ms, "
                          f"K4 beam {g:.4f} ms, faster {w}, auto {r}"
                          for (n, mb, f, g, r), w in zip(rows, faster))
              + f"; the 25 MB rule switches to K5 at {switch} items, the "
              f"times cross at {cross} items; the rule picks the faster "
              f"route at {agree} of {len(rows)} batches")


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


MISTRAL_W4_SHAPES = ((4096, 1024), (4096, 14336), (14336, 4096))


def check_w4(gen: torch.Generator, shapes=W4_SHAPES, rows=(4, 16, 32, 80),
             per_channel: bool = True, also=MISTRAL_W4_SHAPES,
             row_at=(4096, 11008, 4), tag: str = "",
             model: str = "") -> dict:
    """K6 against w4_dense_stacked_plain at the (K, N) decode matmul shapes
    `shapes` (the 7B's by default), g=128 scales and, with `per_channel`,
    per-channel ones, at `rows` rows (by default B = 4, the smoke's batch,
    16 and 32, the rows of 4 beams and of an 8-token verify step, and 80,
    the reference's serving batch), each line with its launch plan, bound
    and rate; at B=4 also against the loop's own arithmetic in torch ops
    (w4_dense_stacked_split_plain) and beside dequantize + torch.matmul;
    then, compared and not timed, `also` (Mistral-7B's wk/wv, gate/up and
    down) at B=4, g=128. The JSON row, w4_gemv + `tag`, carries the times
    at `row_at` (K, N, B), g=128: gate/up at B=4 by default."""
    dev = "cuda"
    layers = 4
    worst = 0.0
    label = f"w4_gemv {model} " if model else "w4_gemv "
    for k, n in shapes:
        np_ = n // 2
        # random bytes: every nibble occurs, -8 included; `layers` distinct
        # weights so that timed calls read device memory, not L2
        w = torch.randint(-128, 128, (layers, k, np_), generator=gen,
                          device=dev, dtype=torch.int8)
        for groups in ((1,) if per_channel else ()) + (k // W4_GROUP,):
            s = (torch.rand(layers, 2, groups, np_, generator=gen,
                            device=dev) * 0.02 + 0.005).bfloat16()
            for b in rows:
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
                print(f"{label}B={b} K={k} N={n} G={groups} "
                      f"[{k6_plan_text(b, k, np_, groups)}]: max_abs_err "
                      f"{err:.3e} rel {rel:.3e} (limits {KERNEL_ATOL} + "
                      f"{KERNEL_RTOL}*|plain|, rel {KERNEL_RTOL}){split}; "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{lim['bound_ms']:.4f} ms by {lim['bound_by']} "
                      f"({lim['bound_ms'] / ms:.1%} of it); "
                      f"{nbytes / 1e6:.2f} MB packed weights + scales -> "
                      f"{nbytes / ms / 1e6:.0f} GB/s {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{label}disagrees with its plain "
                                         "version")
                worst = max(worst, err)
                if b == 4:
                    # no PyTorch call multiplies by packed int4 weights: the
                    # yardstick is K7's, dequantize + torch.matmul
                    lib_ms = device_ms(lambda: walk(
                        lambda x_, p: x_ @ dequantize_int4(
                            p["kernel_q4p"], p["kernel_scale4p"],
                            torch.bfloat16))) / layers
                    print(f"{label}B={b} K={k} N={n} G={groups}: dequantize"
                          f" + torch.matmul {lib_ms:.4f} ms")
                if (k, n, b) == row_at and groups > 1:
                    timing = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, **lim}
        del w
    # compared, not timed
    for k, n in also:
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
    return {"name": "w4_gemv" + tag, "route": "cuda",
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


def check_w4_gemm(gen: torch.Generator, shapes=W4_SHAPES,
                  also=MISTRAL_W4_SHAPES, rows=GEMM_ROWS,
                  per_channel: bool = True, row_at=(4096, 11008, 16),
                  tag: str = "", model: str = "") -> dict:
    """K7 against w4_gemm_plain at the packed-int4 matmul shapes `shapes`
    and `also` (llava-1.5-7b's and Mistral-7B's by default), g=128 scales
    and, with `per_channel`, per-channel ones, at `rows` rows; timed at
    `shapes` with g=128 beside its plain version, K6 (up to 80 rows) and
    the library route, dequantize then torch.matmul. The JSON row, w4_gemm
    + `tag`, carries the times at `row_at` (K, N, M), g=128: by default
    gate/up at 16 rows, the beam step's shape."""
    dev = "cuda"
    layers = 4
    worst = 0.0
    timing = None
    summary = []
    label = f"w4_gemm {model} " if model else "w4_gemm "
    for k, n in shapes + also:
        np_ = n // 2
        timed_shape = (k, n) in shapes
        # random bytes: every nibble occurs, -8 included; `layers` distinct
        # weights so that timed small-M calls read device memory, not L2
        w = torch.randint(-128, 128, (layers, k, np_), generator=gen,
                          device=dev, dtype=torch.int8)
        for groups in ((1,) if per_channel else ()) + (k // W4_GROUP,):
            s = (torch.rand(layers, 2, groups, np_, generator=gen,
                            device=dev) * 0.02 + 0.005).bfloat16()
            for m in rows:
                x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
                ok, err, rel = True, 0.0, 0.0
                for li in (0, layers - 1):
                    got = w4_gemm(x, w[li], s[li])
                    want = w4_gemm_plain(x, w[li], s[li])
                    torch.cuda.synchronize()
                    good, e, r = gemm_within(got, want)
                    ok, err, rel = ok and good, max(err, e), max(rel, r)
                    del got, want
                line = (f"{label}M={m} K={k} N={n} G={groups}"
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
                    if (k, n, m) == row_at:
                        timing = {"ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, **lim}
                    if m in SUMMARY_ROWS and not tag:
                        summary.append((f"K7 {k}x{n} g={W4_GROUP}", m, ms,
                                        plain_ms, lib_ms, lim))
                print(line + f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{label}disagrees with its "
                                         "plain version")
                worst = max(worst, err)
            del s
        del w
    return {"name": "w4_gemm" + tag, "route": "cuda",
            "source": "halva_tpu_torch/csrc/dq_gemm.cu",
            "replaces": "halva_tpu/ops/w4_matmul.py:313",
            "max_abs_err": worst, **timing, "summary": summary}


def check_w4_gemm_dx(gen: torch.Generator) -> None:
    """The w4_gemm Function's dx at the rows of one train forward of the 7B
    (gate/up) against g @ dequant(W).T, bit for bit."""
    dev = "cuda"
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


# (K, N) of the int8 tree's denses: the LLM's three, lm_head, the projector's
# first linear, and CLIP ViT-L's three
W8_SHAPES = W4_SHAPES + ((4096, 32000), (1024, 4096), (1024, 1024),
                         (4096, 1024))
W8_ROWS = (4, 80, 2492)


def check_int8_matmul(gen: torch.Generator, shapes=W8_SHAPES, rows=W8_ROWS,
                      name: str = "int8_matmul", timed=(4096, 11008, 4)
                      ) -> dict:
    """K8 against int8_matmul_plain at the shapes of the int8 tree's denses,
    4, 80 and 2,492 rows (the tower's shapes also at its 2,308), timed beside
    its plain version, the library route (dequantize the weights, then
    torch.matmul: what w8_dense was) and W8A8 (int8_dense: torch._int_mm).
    The JSON line carries gate/up at 4 rows, the decode step's shape; with
    `shapes`, `rows`, `name` and `timed` (K, N, M), a row of those shapes."""
    dev = "cuda"
    layers = 4
    worst = 0.0
    timing = None
    summary = []
    for k, n in shapes:
        q = torch.randint(-127, 128, (layers, k, n), generator=gen,
                          device=dev, dtype=torch.int8)
        sc = (torch.rand(layers, 1, n, generator=gen, device=dev) * 0.002
              + 0.0005).bfloat16()
        tower_rows = (TOWER_ROWS,) if 1024 in (k, n) else ()
        for m in rows + tower_rows:
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
            if (k, n, m) == timed:
                timing = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, **lim}
            if m in SUMMARY_ROWS:
                summary.append((f"K8 {k}x{n}", m, ms, plain_ms, lib_ms, lim))
        del q, sc
    return {"name": name, "route": "cuda",
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


def record(kernels: dict, launches: dict, *names, tag: str = "") -> None:
    """The main path's counts into its kernels' rows; with `tag`, into the
    rows of a config's own shapes (`name + tag`) where the line has one,
    and nowhere else: the untagged rows keep their own main path's."""
    for name in names:
        if not tag:
            kernels[name]["launches"] = launches[name]
        elif name + tag in kernels:
            kernels[name + tag]["launches"] = launches[name]


def beam_routes(params, cfg, inputs, kv_quant, suffix: str):
    """The kernel that beam_route="auto" (ops/decode_attention.
    auto_beam_route) takes for this tree's prompt caches, then the other
    route and its kernel: the beam runs' expected launches."""
    _, _, _, pc, pseg = _prefill_impl(params, cfg, *inputs, kv_quant=kv_quant)
    route = auto_beam_route({k: v[0] for k, v in pc.items()}, pseg, BEAMS)
    del pc
    dim = head_dim_suffix(cfg.llm.head_size)
    names = {"fold": "fold_attn" + suffix + dim,
             "grid": "decode_attn" + suffix + "_beam" + dim}
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
        pen = penalty_table(NEW_TOKENS, 1.0, DEVICE)
        for step in range(at):
            state, _ = select_step(state, logits, step, -1, pen)
        out["select"] = device_ms(
            lambda: select_step(state, logits, at, -1, pen))
        _, parent = select_step(state, logits, at, -1, pen)
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


def train_batch(cfg, seed: int, text: int = TRAIN_TEXT) -> dict:
    """A synthetic DPA batch as scripts/bench_train7b.py:build_batch makes it:
    TRAIN_B rows of `text` tokens with the image sentinel at 1, labels on
    the second half, two phrase spans, random pixels."""
    rng = np.random.RandomState(seed)
    b, t = TRAIN_B, text
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


def train_state_sums(trainable, opt) -> dict:
    """bit_sums of the trainable leaves, their AdamW moments and the
    accumulators."""
    leaves = [t for _, t in tree.flatten(trainable) if t is not None]
    return bit_sums({
        "leaves": leaves, "acc": opt.acc or [],
        "moments": [[opt.adamw.state[t][n] for n in ("exp_avg", "exp_avg_sq")]
                    for t in leaves if t in opt.adamw.state]})


def changed(before: dict, after: dict) -> list:
    return [p for p in before if before[p] != after[p]]


def state_and_ref(policy: dict, tcfg, extra: tuple):
    """init_train_state with the components `extra` trained whole beside
    LoRA, and the frozen reference's overrides (train/run.py's ref_params):
    the initial copy of the projector where it trains (VILA_EXTRA), None
    where only LoRA trains."""
    trainable, frozen, opt, opt_state = init_train_state(policy, tcfg, extra)
    ref = None
    if extra:
        ref = {"projector": tree.map_tree(lambda x: x.detach().clone(),
                                          policy["projector"])}
    return trainable, frozen, opt, opt_state, ref


def run_train(params: dict, kernels: dict, cfg=None, what: str = "",
              suffix: str = "", micro_steps: int = TRAIN_MICRO_STEPS,
              grad_accum: int = 2, compare: bool = True,
              overrides: dict = None, extra: tuple = (),
              tag: str = "", keep: dict = None) -> float:
    """The DPA LoRA train step at full width (llava-v1.5-7b unless `cfg`
    says otherwise): bf16 base, bf16 LoRA r=128 alpha=256 on the 7 linears
    of all layers, remat per layer, loss_chunk=256, micro-batch 2, AdamW
    with warmup and cosine decay, `grad_accum` micro-steps per update;
    `micro_steps` micro-steps, two updates in all (the first at lr(0) = 0).
    `suffix` is the flash kernels' mode on this config. Then, with
    `compare`, one micro-step on the kernel path against the plain path. A
    quantized `params` is the frozen base as it is (its denses launch no
    kernel here: W8A8 is a library product, NF4 and int4 dequantize).
    `overrides` (TrainConfig fields) replace the llava recipe's loss alpha,
    learning rate and warmup; `extra` trains the projector whole, its
    initial copy in the frozen reference; `tag` names the rows of this
    config's shapes that take the K2 and K3 counts; `keep` receives the
    first MESH_ONE_STEPS micro-steps' metrics and the state's checksums
    after them (run_train_world_of_one holds the mesh step to them).
    Returns the mean ms per micro-step after the first."""
    cfg = cfg or CFG
    layers = cfg.llm.num_layers
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    policy = add_lora(params, gen, rank=128, alpha=256.0)
    tcfg = TrainConfig(grad_accum_steps=grad_accum, num_train_steps=400,
                       remat=True, loss_chunk=256, **(overrides or {}))
    trainable, frozen, opt, opt_state, ref = state_and_ref(policy, tcfg,
                                                          extra)
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
        trainable, opt_state, m = step(trainable, frozen, ref, opt_state,
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
        if keep is not None and i < MESH_ONE_STEPS:
            keep.setdefault("metrics", []).append(vals)
            if i == MESH_ONE_STEPS - 1:
                keep["sums"] = train_state_sums(trainable, opt)
        if opt.updates and (i + 1) % tcfg.grad_accum_steps == 0:
            sums.append(bit_sums(policy))
    add_launches(kernels, {name + tag: seen.get(name, 0) for name in (
        "flash_bwd_dq" + suffix, "flash_bwd_dkv" + suffix)})

    lora_paths = {p for p, t in tree.flatten(trainable) if t is not None}
    proj = {p for p in lora_paths if p[0] == "projector"}
    first, second = changed(sums[0], sums[1]), changed(sums[1], sums[2])
    ok = (opt.updates == 2 and not first and second
          and set(second) <= lora_paths
          and (not proj or bool(proj & set(second))))
    print(f"{what}train updates: {opt.updates}; leaves changed by update 1 (lr(0) "
          f"= 0): {len(first)}; by update 2: {len(second)} of "
          f"{len(lora_paths)} trainable leaves ({len(proj)} of the "
          f"projector's, {len(proj & set(second))} of them changed; "
          f"{n_lora / 1e6:.1f} M params), "
          f"{len(set(second) - lora_paths)} others "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the optimizer changed other leaves than the "
                             "trainable ones, or none, or no projector leaf "
                             "where the projector trains")
    steady = times[1:]
    print(f"{what}train main path ({gpu_line()}): "
          f"{statistics.mean(steady) * 1e3:.1f} ms per micro-step (mean of "
          f"micro-steps 1-{len(times) - 1}; all: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" ms), B={TRAIN_B} rows of "
          f"{TRAIN_TEXT + cfg.num_image_tokens - 1} spliced tokens, "
          f"peak memory {peak / 2**30:.2f} GiB")
    del policy, trainable, frozen, opt, opt_state, step
    if compare:
        compare_train(params, batches[0], cfg, what, overrides, extra)
    return statistics.mean(steady) * 1e3


def compare_train(params: dict, batch: dict, cfg=None,
                  what: str = "", overrides: dict = None,
                  extra: tuple = ()) -> None:
    """One micro-step's loss parts and LoRA grads, kernel path against plain
    path, beside the noise floor; on a tree whose lora_b is small and
    nonzero (at B = 0 the KL and the lora_a grads are exactly 0). The two
    loss parts are scalars, and the relative change of a scalar under one
    random perturbation is itself a random draw that can land near 0: the
    floor of each quantity is the largest of FLOOR_DRAWS independent
    perturbations, every one of which is printed. Under `overrides` and
    `extra` (run_train's); where `extra` trains the projector, its grads
    are held the same way."""
    cfg = cfg or CFG
    cmp = comparison_policy(params)
    noise = torch.Generator(device=DEVICE).manual_seed(3)
    kw = {"overrides": overrides, "extra": extra}
    runs = {"kernel": micro_step_grads(cmp, batch, cfg, **kw),
            "plain": micro_step_grads(cmp, batch, cfg, impl="plain", **kw)}
    for i in range(FLOOR_DRAWS):
        runs[f"floor{i}"] = micro_step_grads(cmp, batch, cfg, noise, "plain",
                                             **kw)

    def errs(run):
        got, want = runs[run], runs["plain"]
        out = (abs(got[0] - want[0]) / abs(want[0]),
               abs(got[1] - want[1]) / abs(want[1]),
               rel_err(got[2], want[2]))
        if want[4] is not None:
            out += (rel_err(got[4], want[4]),)
        return out

    got = errs("kernel")
    draws = [errs(f"floor{i}") for i in range(FLOOR_DRAWS)]
    floor = tuple(max(x) for x in zip(*draws))
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in
                 runs.values())
    ok = finite and all(e <= TRAIN_FLOOR_FACTOR * f
                        for e, f in zip(got, floor))
    names = ("alignment", "kl", "LoRA grads", "projector grads")
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
                    # K8's split-K tickets under replay: the loop from CUDA
                    # graphs against its eager body, launch for launch
                    (tok_e, _), _, launches_e = timed_run(
                        lambda: generate_greedy(q8, cfg, *inputs,
                                                max_new_tokens=n, eos_id=-1,
                                                graph=False))
                    same = torch.equal(tok, tok_e) and launches_e == launches
                    print(f"int8 tree, {route} route: the greedy loop from "
                          f"CUDA graphs against its eager body: tokens and "
                          f"launches equal {same} {'ok' if same else 'FAIL'}")
                    if not same:
                        raise AssertionError("int8 tree: the graph loop "
                                             "differs from its eager body")
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
                     impl: str = "auto", packed: int = 0,
                     overrides: dict = None, extra: tuple = ()):
    """(alignment, kl, flat LoRA grads, loss, flat projector grads or None)
    of one DPA micro-step on `policy` on path `impl`, under `overrides`
    and `extra` (run_train's); with `noise`, the text-embedding table is
    perturbed; with `packed` (max_samples), `batch` is a packed batch and
    the step is packed_dpa_step_fns'."""
    tcfg = TrainConfig(grad_accum_steps=1, num_train_steps=400, remat=True,
                       loss_chunk=256, attn_impl=impl, **(overrides or {}))
    trainable, frozen, opt, _, ref = state_and_ref(policy, tcfg, extra)
    if noise is not None:
        frozen = tree.map_tree(lambda x: x, frozen)
        frozen["llm"]["embed"]["embedding"] = perturbed(
            frozen["llm"]["embed"]["embedding"], noise)
    if packed:
        step, _ = packed_dpa_step_fns(cfg, tcfg, opt, max_samples=packed)
    else:
        step, _ = dpa_step_fns(cfg, tcfg, opt)
    _, parts, grads = step.loss_and_grads(trainable, frozen, ref, batch)
    flat = {part: [g.float().flatten() for p, g in tree.flatten(grads)
                   if g is not None and (p[0] == "projector") == part]
            for part in (False, True)}
    torch.cuda.synchronize()
    return (float(parts.alignment), float(parts.divergence),
            torch.cat(flat[False]), float(parts.total),
            torch.cat(flat[True]) if flat[True] else None)


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


def family_logits(params, cfg, inputs, tokens, impl, noise=None,
                  kv_quant=False):
    """First-token logits and COMPARE_STEPS decode-step logits fed `tokens`,
    on path `impl`, over a `kv_quant` prompt cache; with `noise`, the
    spliced prompt embeddings and the decode tokens' embeddings are
    perturbed by 2^-7 N(0, 1) relative."""
    ids, images, lens = inputs
    b, s = ids.shape

    seg = (torch.arange(s, device=DEVICE)[None, :] < lens[:, None]).int()
    sp = llava.splice_image_tokens(
        params, cfg, ids, llava.encode_images(params, cfg, images), seg)
    hidden, pc = llama.prefill(params["llm"], cfg.llm,
                               perturbed(sp.embeds, noise), sp.segment_ids,
                               sp.positions, attn_impl=impl,
                               quantize_cache=kv_quant)
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


def step_iters(impl: str) -> int:
    """Replays behind a decode step's device time on path `impl`."""
    return PLAIN_STEP_ITERS if impl == "plain" else 20


def decode_step_ms(params, cfg, pc, pseg, positions, token, impl) -> float:
    """Device ms of one decode step at gen slot 8 on path `impl`, replayed
    from a CUDA graph (no host time)."""
    at = 8
    gen_cache = init_gen_cache_like(cfg.llm, token.shape[0], NEW_TOKENS, pc)
    emb = llama.embed(params["llm"], token)
    return device_ms(lambda: llama.decode_step(
        params["llm"], cfg.llm, emb, positions + at, pc, pseg, gen_cache, at,
        attn_impl=impl), iters=step_iters(impl))


def run_family_serving(params, cfg, name: str, kernels: dict,
                       prefill_kernel: str, decode_kernel, kv_quant=False,
                       step_launches=None, tag: str = "") -> torch.Tensor:
    """Greedy decode of the 4 requests on one of `cfg`'s trees with a
    `kv_quant` prompt cache: the main path with its launches asserted (K1 in
    `prefill_kernel`'s mode once per layer; `decode_kernel` once per layer
    and step, or no decode kernel at all where the reference's rule takes
    the plain attention; `step_launches`, {kernel: launches a step}, beside
    them, asserted and recorded only into rows of `tag`), then first-token
    and decode-step logits against the plain path. Returns the main run's
    tokens."""
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]
    lens = spliced_lens(cfg)
    route = decode_route(cfg, max(lens), 128)
    if (route == "kernel") != (decode_kernel is not None):
        raise AssertionError(f"{name}: unexpected decode route {route}")
    with torch.inference_mode():
        generate_greedy(params, cfg, *inputs, max_new_tokens=2, eos_id=-1,
                        kv_quant=kv_quant)
        _, prefill_s, _ = timed_run(lambda: _prefill_impl(
            params, cfg, *inputs, kv_quant=kv_quant))
        torch.cuda.reset_peak_memory_stats()
        (tokens, num), total_s, launches = timed_run(lambda: generate_greedy(
            params, cfg, *inputs, max_new_tokens=NEW_TOKENS, eos_id=-1,
            kv_quant=kv_quant))
        peak = torch.cuda.max_memory_allocated()
    want = {prefill_kernel: layers}
    if decode_kernel is not None:
        want[decode_kernel] = layers * NEW_TOKENS
    attn = list(want)
    want.update({k: n * NEW_TOKENS for k, n in (step_launches or {}).items()})
    expect_launches(launches, want, f"{name} main run")
    record(kernels, launches, *(list(want) if tag else attn), tag=tag)
    ok = in_vocab(tokens, cfg) and bool((num == NEW_TOKENS).all())
    decode_s = total_s - prefill_s
    print(f"{name} main path: tokens {tuple(tokens.shape)} in [0, "
          f"{cfg.llm.vocab_size}); prefill {prefill_s * 1e3:.2f} ms (B={b}, "
          f"{max(lens)} spliced tokens), decode "
          f"{decode_s / NEW_TOKENS * 1e3:.3f} ms/step on the "
          f"{'kernel' if decode_kernel else 'plain position-aware'} route, "
          f"{b * NEW_TOKENS / decode_s:.1f} decode tokens/s, "
          f"{b * NEW_TOKENS / total_s:.1f} tokens/s end to end "
          f"({total_s:.3f} s), peak memory {peak / 2**30:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: generated tokens out of range")
    with torch.inference_mode():
        _, _, slen, pc, pseg = _prefill_impl(params, cfg, *inputs,
                                             kv_quant=kv_quant)
        step_ms = {impl: decode_step_ms(params, cfg, pc, pseg, slen,
                                        tokens[:, 8, None], impl)
                   for impl in ("auto", "plain")}
        del pc
    print(f"{name} decode step device time (a CUDA graph, gen slot 8, B={b}):"
          f" {step_ms['auto']:.3f} ms on the "
          f"{'K4' if decode_kernel else 'plain position-aware'} route, "
          f"{step_ms['plain']:.3f} ms with attn_impl='plain' "
          f"({'decode_attend_plain without a bias' if decode_kernel else 'the same route'}"
          f"; reduced: {PLAIN_STEP_ITERS} replays)"
          f"; {decode_s / NEW_TOKENS * 1e3:.3f} ms on the host clock in the "
          f"main run: the device idles "
          f"{1 - step_ms['auto'] / (decode_s / NEW_TOKENS * 1e3):.1%} of a "
          "step")
    noise = torch.Generator(device=DEVICE).manual_seed(6)
    with torch.inference_mode():
        runs = {"auto": family_logits(params, cfg, inputs, tokens, "auto",
                                      kv_quant=kv_quant),
                "plain": family_logits(params, cfg, inputs, tokens, "plain",
                                       kv_quant=kv_quant),
                "floor": family_logits(params, cfg, inputs, tokens, "plain",
                                       noise, kv_quant)}
    floor_check(runs, f"{name} first token and decode steps 0-"
                f"{COMPARE_STEPS - 1}:")
    return tokens


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


# ---- the decode loops from CUDA graphs, the bench entry, the loader -------

REPO = os.path.dirname(os.path.abspath(__file__))
# steps of each graph loop and of its eager reference (reduced from 32 for
# the smoke's time limit)
GRAPH_TOKENS = 16
GRAPH_AIM = 1.25  # host clock over device time per step: reported, not held
GRAPH_AT = 8  # gen slot at which a body's device time is taken
LOADER_RANK, LOADER_ALPHA = 128, 256.0  # the HALVA adapters' PEFT config


def loop_launches(kind, cfg, kv_quant, rows, steps, beam_kernel=None,
                  int4=False) -> dict:
    """The launches a decode loop of `steps` steps makes after its prefill:
    the step's attention kernel once a layer, and on the int4g tree the
    packed-int4 matmul seven times a layer at the step's rows."""
    layers = cfg.llm.num_layers
    suffix = {False: "", "int8": "_kv8", "int4": "_kv4"}[kv_quant]
    dim = head_dim_suffix(cfg.llm.head_size)
    attn = {"greedy": "decode_attn" + suffix + dim, "beam": beam_kernel,
            "verify": "fold_attn" + suffix + "_shared" + dim}[kind]
    want = {attn: layers * steps}
    if int4:
        want.update(w4_mm_launches(rows, 7 * layers * steps))
    return want


def body_device_ms(kind, params, cfg, inputs, prefill, k) -> float:
    """Device ms of one step of the loop's body, replayed from a CUDA graph
    at gen slot GRAPH_AT (device_ms runs it 24 times: the state has room)."""
    ids, _, lens = inputs
    first_tok, first_logits, slen, pc, pseg = prefill
    if kind == "greedy":
        state, bodies = decode_loop(params, cfg, first_tok, slen, pc, pseg,
                                    GRAPH_AT + 64, -1)
        state.step.fill_(GRAPH_AT)
        return device_ms(bodies[0])
    if kind == "beam":
        _, step, bodies = beam_loop(params, cfg, first_logits, slen, pc,
                                    pseg, GRAPH_AT + 64, -1, BEAMS)
        step.fill_(GRAPH_AT)
        # the two bodies (one per reorder direction): two steps a replay
        return device_ms(lambda: [body() for body in bodies]) / 2
    _, bodies = spec_loop(params, cfg, ids, lens, first_tok, slen, pc, pseg,
                          24 * k + 64, -1, k)
    return device_ms(bodies[0])


def graph_loop_case(params, cfg, inputs, label, kind, kv_quant, k=None,
                    int4=False) -> dict:
    """One decode loop on one prefill: from CUDA graphs (the port's default
    on the card), then the same bodies eagerly on the card. Asserts equal
    tokens and equal launch counts (the counts set to 0 before each run,
    read after it), the expected ones; returns the host-clock and device
    times per step."""
    ids, _, lens = inputs
    b = ids.shape[0]
    n = GRAPH_TOKENS
    with torch.inference_mode():
        beam_kernel = None
        if kind == "beam":
            beam_kernel = beam_routes(params, cfg, inputs, kv_quant, {
                False: "", "int8": "_kv8", "int4": "_kv4"}[kv_quant])[0]
        prefill = _prefill_impl(params, cfg, *inputs, kv_quant=kv_quant)
        first_tok, first_logits, slen, pc, pseg = prefill
        runs = {}
        for graph in (None, False):
            st = {}
            torch.cuda.synchronize()
            _kernels.reset_launches()
            if kind == "greedy":
                tok = _decode_impl(params, cfg, first_tok, slen, pc, pseg, n,
                                   -1, graph=graph, loop_stats=st)[0]
            elif kind == "beam":
                tok = _beam_decode_impl(params, cfg, first_logits, slen, pc,
                                        pseg, n, -1, BEAMS, graph=graph,
                                        loop_stats=st)[0]
            else:
                tok = _spec_decode_impl(params, cfg, ids, lens, first_tok,
                                        slen, pc, pseg, n, -1, k,
                                        graph=graph, stats=st)[0]
            runs["graph" if graph is None else "eager"] = (
                tok, dict(_kernels.launches), st)
        dev = body_device_ms(kind, params, cfg, inputs, prefill, k)
        del prefill, pc
    (tok_g, launches_g, st_g), (tok_e, launches_e, st_e) = (
        runs["graph"], runs["eager"])
    steps = st_g["steps"]
    rows = b * (BEAMS if kind == "beam" else k if kind == "verify" else 1)
    want = loop_launches(kind, cfg, kv_quant, rows, steps, beam_kernel, int4)
    if steps < 2:
        raise AssertionError(f"graph loop {label}: {steps} step, no replay")
    host_g = ((st_g["loop_s"] - st_g["first_step_s"] - st_g["capture_s"])
              / (steps - 1) * 1e3)
    host_e = st_e["loop_s"] / st_e["steps"] * 1e3
    same = torch.equal(tok_g, tok_e)
    ok = (same and st_g["graph"] and not st_e["graph"]
          and st_e["steps"] == steps and launches_g == launches_e == want)
    ratio = host_g / dev
    print(f"graph loop {label}: {steps} steps; host clock {host_g:.3f} ms per"
          f" step replayed from the graph ({steps - 1} replays, the first "
          f"step eager: {st_g['first_step_s'] * 1e3:.1f} ms), {host_e:.3f} "
          f"ms per step of the eager body; device {dev:.3f} ms per step (the"
          f" body from a graph, gen slot {GRAPH_AT}); idle "
          f"{max(0.0, 1 - dev / host_g):.1%} of the graph loop's host clock;"
          f" host/device {ratio:.3f} (aim {GRAPH_AIM}: "
          f"{'met' if ratio <= GRAPH_AIM else 'not met'}); capture "
          f"{st_g['capture_s'] * 1e3:.1f} ms; tokens equal to the eager "
          f"body's {same}; launches {launches_g} (eager {launches_e}, "
          f"expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"graph loop {label}: differs from the eager "
                             "body or from the expected launches")
    return {"label": label, "host_ms": host_g, "eager_ms": host_e,
            "device_ms": dev, "capture_ms": st_g["capture_s"] * 1e3}


def run_graph_loops(params, cfg, int4: bool,
                    model: str = "llava-v1.5-7b") -> None:
    """The greedy, beam and verify loops of one tree as the port runs them
    on the card (CUDA graphs), each against its eager body: the bf16 tree
    with bf16 KV, or the int4g tree with int4 prompt KV (and its greedy
    loop at batch 80 too)."""
    inputs = make_inputs(cfg)
    kv = "int4" if int4 else False
    name = f"{model} {'int4g, int4 KV' if int4 else 'bf16'}"
    cases = [("greedy", None, inputs, 4), ("beam", None, inputs, 4),
             ("verify", 4, inputs, 4), ("verify", 8, inputs, 4)]
    if int4:
        big = tuple(t.repeat_interleave(BATCH80 // t.shape[0], dim=0)
                    for t in inputs)
        cases.insert(1, ("greedy", None, big, BATCH80))
    results = []
    for kind, k, inp, b in cases:
        what = {"greedy": "greedy", "beam": f"beam {BEAMS}",
                "verify": f"verify draft_k {k}"}[kind]
        results.append(graph_loop_case(
            params, cfg, inp, f"{name} {what} B={b}", kind, kv, k, int4))
        torch.cuda.empty_cache()
    clock(f"graph loops on {name}")
    print(f"graph loops on {name} (reduced: {GRAPH_TOKENS} of 32 tokens; "
          f"{gpu_line()}): "
          + "; ".join(f"{r['label']} {r['host_ms']:.3f} / {r['device_ms']:.3f}"
                      f" ms host / device per step (eager {r['eager_ms']:.3f})"
                      for r in results))


def run_bench() -> dict:
    """`python -m halva_tpu_torch.bench` as a user runs it: its own process,
    its defaults (llava-v1.5-7b, random int4g tree, int4 prompt KV, batch 80,
    128 tokens, W4A8 on); its JSON line printed on a line of its own. Its
    launches are not read here: its decode loop is the int4g greedy graph
    loop held above at batch 80."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "halva_tpu_torch.bench"],
                       capture_output=True, text=True, cwd=REPO, timeout=600)
    secs = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        print(p.stderr[-4000:])
        raise AssertionError(f"bench: exit {p.returncode}")
    out = json.loads(lines[-1])
    d = out["detail"]
    ok = (len(lines) == 1 and out["value"] > 0 and d["batch"] == BATCH80
          and d["decode_tokens"] == 128 and d["weights"] == "int4g")
    print(lines[-1])
    print(f"bench: python -m halva_tpu_torch.bench in {secs:.1f} s (its own "
          f"process: start, random tree, warm-up and 3 timed batches); "
          f"{out['value']} imgs/s, {out['measured_tokens_per_sec']} tokens/s,"
          f" {d['step_time_s']} s per batch of {d['batch']} ({gpu_line()}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bench: unexpected JSON line")
    return out


_PEFT = (("self_attn", "q_proj", "attn", "wq"),
         ("self_attn", "k_proj", "attn", "wk"),
         ("self_attn", "v_proj", "attn", "wv"),
         ("self_attn", "o_proj", "attn", "wo"),
         ("mlp", "gate_proj", "mlp", "gate"), ("mlp", "up_proj", "mlp", "up"),
         ("mlp", "down_proj", "mlp", "down"))
_TOWER = "model.vision_tower.vision_tower.vision_model."


def hf_shards(params, cfg) -> list:
    """The tree as the released llava-v1.5-7b checkpoint stores it: HF names,
    (out, in) weights, two shards split at the middle layer (the embedding
    in the first; the norm, lm_head, CLIP tower and projector in the
    second). Tensors on the card."""
    llm, vis = params["llm"], params["vision"]
    lay = llm["layers"]
    half = cfg.llm.num_layers // 2
    shards = [{"model.embed_tokens.weight": llm["embed"]["embedding"]}, {}]
    for i in range(cfg.llm.num_layers):
        sd = shards[i >= half]
        for part, hf, group, name in _PEFT:
            sd[f"model.layers.{i}.{part}.{hf}.weight"] = lay[group][name][
                "kernel"][i].t()
        sd[f"model.layers.{i}.input_layernorm.weight"] = lay["input_norm"][
            "scale"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = lay[
            "post_attn_norm"]["scale"][i]
    sd = shards[1]
    sd["model.norm.weight"] = llm["final_norm"]["scale"]
    sd["lm_head.weight"] = llm["lm_head"]["kernel"].t()
    sd[_TOWER + "embeddings.patch_embedding.weight"] = vis["patch_embed"][
        "kernel"].permute(3, 2, 0, 1)
    sd[_TOWER + "embeddings.position_embedding.weight"] = vis["pos_embed"][
        "embedding"]
    sd[_TOWER + "embeddings.class_embedding"] = vis["cls_token"]["embedding"]
    for hf, ours in (("pre_layrnorm", "pre_ln"), ("post_layernorm",
                                                  "post_ln")):
        sd[_TOWER + hf + ".weight"] = vis[ours]["scale"]
        sd[_TOWER + hf + ".bias"] = vis[ours]["bias"]
    vl = vis["layers"]
    for i in range(cfg.vision.num_layers):
        e = f"{_TOWER}encoder.layers.{i}."
        for hf, ours in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            sd[e + hf + ".weight"] = vl[ours]["scale"][i]
            sd[e + hf + ".bias"] = vl[ours]["bias"][i]
        for hf, group, name in (("self_attn.q_proj", "attn", "wq"),
                                ("self_attn.k_proj", "attn", "wk"),
                                ("self_attn.v_proj", "attn", "wv"),
                                ("self_attn.out_proj", "attn", "wo"),
                                ("mlp.fc1", "mlp", "fc1"),
                                ("mlp.fc2", "mlp", "fc2")):
            sd[e + hf + ".weight"] = vl[group][name]["kernel"][i].t()
            sd[e + hf + ".bias"] = vl[group][name]["bias"][i]
    for j, lin in enumerate(params["projector"]["layers"]):
        sd[f"model.mm_projector.{2 * j}.weight"] = lin["kernel"].t()
        sd[f"model.mm_projector.{2 * j}.bias"] = lin["bias"]
    return shards


def peft_adapter(cfg, seed: int = 11) -> dict:
    """A random rank-128 PEFT adapter of every LLM projection, bf16, in
    PEFT's names: lora_A (r, in), lora_B (out, r)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    llm = cfg.llm
    d, f, r = llm.hidden_size, llm.intermediate_size, LOADER_RANK
    dims = {"q_proj": (d, llm.num_heads * llm.head_size),
            "k_proj": (d, llm.kv_heads * llm.head_size),
            "v_proj": (d, llm.kv_heads * llm.head_size),
            "o_proj": (llm.num_heads * llm.head_size, d),
            "gate_proj": (d, f), "up_proj": (d, f), "down_proj": (f, d)}
    sd = {}
    for i in range(llm.num_layers):
        for part, hf, _, _ in _PEFT:
            din, dout = dims[hf]
            key = f"base_model.model.model.layers.{i}.{part}.{hf}"
            sd[key + ".lora_A.weight"] = (torch.randn(
                r, din, generator=gen, device=DEVICE) * din**-0.5).bfloat16()
            sd[key + ".lora_B.weight"] = (torch.randn(
                dout, r, generator=gen, device=DEVICE) * 1e-3).bfloat16()
    return sd


def merged_int4g(params, cfg, adapter: dict) -> dict:
    """quantize_params_int4(merge(tree, adapter), group_size=128) on the
    card from the same tensors, one stack at a time: each adapted kernel in
    fp32 plus (lora_A^T @ lora_B^T) * alpha / r, quantized before the
    next is merged; float leaves in bf16, as the loader's tree."""
    ref = tree.map_tree(lambda x: x, params)
    scale = torch.full((cfg.llm.num_layers,), LOADER_ALPHA / LOADER_RANK,
                       dtype=torch.float32, device=DEVICE)
    for part, hf, group, name in _PEFT:
        key = "base_model.model.model.layers.{}.%s.%s" % (part, hf)
        a = torch.stack([adapter[key.format(i) + ".lora_A.weight"].t()
                         for i in range(cfg.llm.num_layers)]).float()
        b = torch.stack([adapter[key.format(i) + ".lora_B.weight"].t()
                         for i in range(cfg.llm.num_layers)]).float()
        node = ref["llm"]["layers"][group]
        merged = node[name]["kernel"].float() + torch.einsum(
            "...ir,...ro->...io", a, b) * scale[..., None, None]
        node[name] = quantize_params_int4({"kernel": merged},
                                          group_size=W4_GROUP)
        del merged
    ref = quantize_params_int4(ref, group_size=W4_GROUP)
    return tree.map_tree(lambda t: t if t.dtype in (
        torch.int8, torch.int32, torch.bfloat16) else t.bfloat16(), ref)


def same_tree(got, want) -> bool:
    g, w = dict(tree.flatten(got)), dict(tree.flatten(want))
    return g.keys() == w.keys() and all(
        g[p].dtype == w[p].dtype and g[p].shape == w[p].shape
        and torch.equal(g[p], w[p]) for p in w)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def run_loader(params, cfg) -> float:
    """models/builder.load_pretrained_model at full width: a random
    llava-v1.5-7b checkpoint written from the bf16 tree in the released
    layout (bf16 pytorch_model-0000{1,2}-of-00002.bin + config.json) and a
    random rank-128 PEFT adapter, under build/ (removed at the end); the
    int4g load cold, then warm from the tree cache; both trees bitwise
    equal to each other and to the int4g tree of the merge computed on the
    card from the same tensors; then one greedy run on the loaded tree
    against the in-memory one, token for token. (d) Then `python -m
    halva_tpu_torch.convert_checkpoint` on the same shards in its own
    process, its save_params dir read back by train/checkpoint.load_params
    and held equal to the bf16 tree bit for bit. Returns the warm load's
    seconds."""
    root = os.path.join(REPO, "build", f"smoke_loader_{os.getpid()}")
    base, adapter_dir = os.path.join(root, "base"), os.path.join(root, "lora")
    was = os.environ.get("HALVA_QUANT_CACHE")
    try:
        os.makedirs(base)
        os.makedirs(adapter_dir)
        # the bf16 shards, the int4g tree cache and the converter's
        # save_params dir side by side (~14 + 4 + 14 GB at 7B)
        need = 3 * tree_bytes(params)
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(f"loader: {free / 1e9:.1f} GB free under "
                                 f"build/, {need / 1e9:.1f} GB needed")
        t0 = time.perf_counter()
        shards = hf_shards(params, cfg)
        for i, sd in enumerate(shards, 1):
            torch.save({k: v.contiguous().cpu() for k, v in sd.items()},
                       os.path.join(base, f"pytorch_model-{i:05d}-of-"
                                          f"{len(shards):05d}.bin"))
        del shards
        with open(os.path.join(base, "config.json"), "w") as f:
            json.dump({"model_type": "llava", "hidden_size":
                       cfg.llm.hidden_size, "num_hidden_layers":
                       cfg.llm.num_layers, "mm_use_im_start_end": False,
                       "mm_use_im_patch_token": False}, f)
        adapter = peft_adapter(cfg)
        torch.save({k: v.cpu() for k, v in adapter.items()},
                   os.path.join(adapter_dir, "adapter_model.bin"))
        with open(os.path.join(adapter_dir, "adapter_config.json"), "w") as f:
            json.dump({"r": LOADER_RANK, "lora_alpha": LOADER_ALPHA,
                       "target_modules": [p[1] for p in _PEFT]}, f)
        write_s = time.perf_counter() - t0
        clock("loader: the checkpoint written")
        os.environ["HALVA_QUANT_CACHE"] = os.path.join(root, "cache")
        times, trees = {}, {}
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trees[run], got_cfg = load_pretrained_model(
                adapter_dir, model_base=base, quant="int4g")
            torch.cuda.synchronize()
            times[run] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        warm_same = same_tree(trees["warm"], trees["cold"])
        del trees["warm"]
        with torch.no_grad():
            ref = merged_int4g(params, cfg, adapter)
        del adapter
        torch.cuda.empty_cache()
        ref_same = same_tree(trees["cold"], ref)
        inputs = make_inputs(cfg)
        with torch.inference_mode():
            tok_l, _ = generate_greedy(trees["cold"], got_cfg, *inputs,
                                       max_new_tokens=NEW_TOKENS, eos_id=-1,
                                       kv_quant="int4")
            tok_r, _ = generate_greedy(ref, cfg, *inputs,
                                       max_new_tokens=NEW_TOKENS, eos_id=-1,
                                       kv_quant="int4")
        tokens_same = torch.equal(tok_l, tok_r)
        ok = (warm_same and ref_same and tokens_same
              and got_cfg.llm == cfg.llm)
        print(f"loader (llava-v1.5-7b + rank-{LOADER_RANK} PEFT adapter, "
              f"int4g): checkpoint {dir_bytes(base) / 1e9:.3f} GB in 2 bf16 "
              f"shards, adapter {dir_bytes(adapter_dir) / 1e9:.3f} GB, "
              f"written in {write_s:.1f} s; cold load {times['cold']:.1f} s "
              f"(read, convert, merge, quantize on the card, write the tree "
              f"cache), warm load {times['warm']:.1f} s from the "
              f"{dir_bytes(os.path.join(root, 'cache')) / 1e9:.3f} GB npz; "
              f"warm tree == cold tree {warm_same}, == the merge quantized "
              f"in memory {ref_same}; greedy tokens ({NEW_TOKENS} x 4, int4 "
              f"KV) equal {tokens_same} ({gpu_line()}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("loader: the loaded tree differs")
        del trees, ref
        torch.cuda.empty_cache()
        clock("loader: cold and warm int4g loads")
        run_converter(params, base, os.path.join(root, "converted"))
        return times["warm"]
    finally:
        if was is None:
            os.environ.pop("HALVA_QUANT_CACHE", None)
        else:
            os.environ["HALVA_QUANT_CACHE"] = was
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def run_converter(params, hf_dir: str, out: str) -> None:
    """(d) `python -m halva_tpu_torch.convert_checkpoint --hf-dir hf_dir
    --out out` in its own process, as a user runs it (bf16, on the card);
    then train/checkpoint.load_params(out, like=params) equal to `params`,
    the bf16 tree that wrote the shards, bit for bit. Prints its seconds and
    GB/s; removes `out`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "halva_tpu_torch.convert_checkpoint", "--hf-dir",
                        hf_dir, "--out", out], capture_output=True, text=True,
                       cwd=REPO, timeout=600)
    secs = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        print(p.stderr[-4000:])
        raise AssertionError(f"convert_checkpoint: exit {p.returncode}")
    nbytes = dir_bytes(out)
    t0 = time.perf_counter()
    got = ckpt_lib.load_params(out, params)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same = same_tree(got, params)
    del got
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    gb = tree_bytes(params) / 1e9
    print(f"converter: python -m halva_tpu_torch.convert_checkpoint on the "
          f"2 bf16 shards in its own process, {secs:.1f} s from start to exit"
          f" ({gb / secs:.3f} GB/s of the {gb:.3f} GB tree: start, read, "
          f"convert on the card, save_params), {nbytes / 1e9:.3f} GB "
          f"written; it said {lines[-1][:100]!r}...; load_params(out, like="
          f"the bf16 tree) in {read_s:.1f} s ({gb / read_s:.3f} GB/s), equal "
          f"to the tree that wrote the shards bit for bit {same} "
          f"({gpu_line()}) {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("convert_checkpoint: the tree differs from the "
                             "one that wrote the shards")


# ---- the train CLI (train/run.py) at full width ----------------------------

CLI_SAMPLES = 8  # one epoch of 4 micro-batches of TRAIN_B: two updates
CLI_STEPS = 4
# the train CLI's runs (plain and packed) take the first CLI_LAYERS of the
# bf16 tree's 32 layers at full width, under their own preset name: their
# time is the base's write, loads and exports, which scale with the depth
CLI_LAYERS = 8
CLI_PRESET = f"llava-v1.5-7b-{CLI_LAYERS}l"
CLI_DECODE = 8  # greedy tokens decoded from the trained checkpoint
CLI_RTOL = 1e-5  # the resumed run's loss and kl (tests/test_train_e2e.py)


def depth_cut(params, cfg, layers: int):
    """The tree with the first `layers` of its LLM layer stacks (views) and
    the config of that depth, the widths unchanged."""
    llm = dict(params["llm"], layers=tree.map_tree(
        lambda t: t[:layers], params["llm"]["layers"]))
    return dict(params, llm=llm), at_depth(cfg, layers)


def cli_base(params, cfg, directory: str):
    """save_params of the CLI_LAYERS cut of `params` into `directory`, its
    config registered as CLI_PRESET (the caller pops it when done); returns
    (that config, the save's seconds)."""
    cut, cut_cfg = depth_cut(params, cfg, CLI_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_lib.save_params(directory, cut)
    PRESETS[CLI_PRESET] = cut_cfg
    return cut_cfg, time.perf_counter() - t0


class CliSamples:
    """HallDataset.__getitem__'s samples at the recipe's shapes (those of
    train_batch: TRAIN_TEXT tokens with the image sentinel at 1, labels on
    the second half, two phrase spans, random pixels), made from a seed.
    The card's machine has no tokenizer library and no Pillow: the text
    encoding and the image decode are held on the CPU in tests. The
    sampler reads `modality_lengths`."""

    def __init__(self, cfg, n: int = CLI_SAMPLES):
        rng = np.random.RandomState(7)
        t, size = TRAIN_TEXT, cfg.vision.image_size
        hi = min(30000, cfg.llm.vocab_size)

        def seq(phrases: bool):
            ids = rng.randint(5, hi, t).astype(np.int32)
            ids[1] = IMAGE_TOKEN_INDEX
            lab = ids.copy()
            lab[: t // 2] = IGNORE_INDEX
            sg = np.zeros(t, np.int32)
            if phrases:
                sg[t // 2: t // 2 + 3] = 1
                sg[t // 2 + 4: t // 2 + 7] = 2
            return ids, lab, sg

        self.items = []
        for _ in range(n):
            (i1, l1, g1), (i2, l2, g2), (i3, l3, _) = (
                seq(True), seq(True), seq(False))
            self.items.append(dict(
                input_ids=i1, labels=l1, pos_signs=g1, neg_input_ids=i2,
                neg_labels=l2, neg_signs=g2, ref_input_ids=i3,
                ref_labels=l3,
                image=rng.randn(3, size, size).astype(np.float32),
                ref_image=rng.randn(3, size, size).astype(np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    @property
    def modality_lengths(self):
        return [len(s["input_ids"]) for s in self.items]


class _CliProbe:
    """The train CLI's host clock and checkpoint saves, read from the
    outside: StepTimer's tick intervals (one micro-step each, the loop's
    fetch, copy, launch and metrics sync included) and each
    CheckpointManager.save's seconds and bytes. Installed on the run
    module's names for one call; nothing of the step changes."""

    def __init__(self, run_lib, ckpt_lib):
        probe = self
        self.dts, self.saves = [], []

        class Timer(run_lib.StepTimer):
            def tick(self):
                dt = super().tick()
                if dt is not None:
                    probe.dts.append(dt)
                return dt

        class Manager(ckpt_lib.CheckpointManager):
            def save(self, step, trainable, opt_state):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                done = super().save(step, trainable, opt_state)
                if done:
                    probe.saves.append((step, time.perf_counter() - t0,
                                        dir_bytes(self._step_dir(step))))
                return done

        self._names = ((run_lib, "StepTimer", Timer),
                       (ckpt_lib, "CheckpointManager", Manager))

    def __enter__(self):
        self._was = [getattr(m, n) for m, n, _ in self._names]
        for m, n, v in self._names:
            setattr(m, n, v)
        return self

    def __exit__(self, *exc):
        for (m, n, _), v in zip(self._names, self._was):
            setattr(m, n, v)


def _metrics(path: str) -> dict:
    with open(path) as f:
        return {m["step"]: m for m in map(json.loads, f)}


def _greedy_one(params, cfg) -> tuple:
    ids, images, lens = make_inputs(cfg)
    _kernels.reset_launches()
    with torch.inference_mode():
        tokens, _ = generate_greedy(params, cfg, ids[:1], images[:1],
                                    lens[:1], max_new_tokens=CLI_DECODE,
                                    eos_id=-1)
    torch.cuda.synchronize()
    return tokens, dict(_kernels.launches)


def run_train_cli(params, cfg, train_ms: float, then=None) -> None:
    """train.run.train, the train CLI's entry, at llava-v1.5-7b's full width
    on the first CLI_LAYERS layers of the bf16 tree: their save_params dir
    as the base (no orbax);
    run A, 4 micro-steps of 2 rows at grad_accum 2, LoRA r=128, a save
    every 2, the component dirs at the end, with its K1-K3 launches per
    micro-step those of run_train's step at that depth; run B stopped at 2
    and resumed to 4,
    whose steps 3 and 4 equal A's; the component checkpoint loaded by the
    eval builder, bit for bit merge_lora of A's tree, and 8 greedy tokens
    decoded from it through the graph loop (K4) equal to the in-memory
    merged tree's. Every directory under build/ is removed, and each tree
    freed, once its check is done. `then(base, config)` runs a further
    phase on the same base dir."""
    from halva_tpu_torch.train import lora as lora_lib
    from halva_tpu_torch.train import run as run_lib

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "build", f"smoke_train_cli_{os.getpid()}")
    base = os.path.join(root, "base")
    try:
        os.makedirs(root)
        need = 2.5 * tree_bytes(depth_cut(params, cfg, CLI_LAYERS)[0])
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(f"train CLI: {free / 1e9:.1f} GB free "
                                 f"under build/, {need / 1e9:.1f} GB needed")
        cfg, save_s = cli_base(params, cfg, base)
        layers = cfg.llm.num_layers
        print(f"train CLI: save_params of the bf16 tree's first {layers} "
              f"layers: "
              f"{dir_bytes(base) / 1e9:.3f} GB in {save_s:.1f} s "
              f"({dir_bytes(base) / 1e9 / save_s:.2f} GB/s)")
        ds = CliSamples(cfg)

        def rcfg(out, max_steps, components=False):
            return run_lib.RunConfig(
                model=CLI_PRESET, model_path=base,
                output_dir=os.path.join(root, out), per_device_batch=TRAIN_B,
                grad_accum_steps=2, lora_r=128, lora_alpha=256.0,
                max_steps=max_steps, save_steps=2,
                save_component_dirs=components, device=DEVICE)

        # run A: the main path of this phase; counts start at 0 right
        # before it
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with _CliProbe(run_lib, ckpt_lib) as probe:
            final = run_lib.train(rcfg("A", CLI_STEPS, components=True),
                                  None, dataset=ds)
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        per_step = {k: v / CLI_STEPS for k, v in launches.items()}
        want = {"flash_fwd": 5 * layers, "flash_bwd_dq": 2 * layers,
                "flash_bwd_dkv": 2 * layers}
        expect_launches(per_step, want, "train CLI run A, per micro-step "
                        f"(run_train's at {layers} layers)")
        a = _metrics(os.path.join(root, "A", "metrics.jsonl"))
        finite = set(a) == set(range(1, CLI_STEPS + 1)) and all(
            np.isfinite(a[s][k]) for s in a for k in ("loss", "kl",
                                                      "grad_norm"))
        # tick intervals: the first after micro-step 1; the one after the
        # step-2 save holds that save
        dts = [d * 1e3 for d in probe.dts]
        saved_at = {s for s, _, _ in probe.saves}
        clean = [d for i, d in enumerate(dts, 2) if i - 1 not in saved_at]
        host_ms = statistics.mean(clean)
        print(f"train CLI run A ({gpu_line()}): {CLI_STEPS} micro-steps in "
              f"{a_s:.1f} s with the base load, the saves and the exports; "
              f"host ms per micro-step from StepTimer "
              + ", ".join(f"{d:.1f}" for d in dts)
              + f" (mean without a save: {host_ms:.1f}) at {layers} layers, "
              f"beside run_train's device {train_ms:.1f} ms per micro-step "
              f"at {CFG.llm.num_layers} (the CLI's loss takes whole "
              "logits, run_train's loss_chunk=256); loss "
              + ", ".join(f"{a[s]['loss']:.6f}" for s in sorted(a))
              + f"; kl {a[max(a)]['kl']:.3e} "
              f"{'ok' if finite else 'FAIL'}")
        for step, sec, nbytes in probe.saves:
            print(f"train CLI checkpoint save at step {step}: "
                  f"{nbytes / 1e9:.3f} GB (LoRA leaves, Adam moments and "
                  f"count, accumulators) in {sec:.2f} s")
        if not finite:
            raise AssertionError("train CLI: a metric is missing or not "
                                 "finite")

        # the component checkpoint, loaded by the eval builder, against the
        # merge of A's tree; then a greedy decode from each
        with torch.no_grad():
            merged = lora_lib.merge_lora(final)
        del final
        torch.cuda.empty_cache()
        comp = os.path.join(root, "A", "components")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, lcfg = load_pretrained_model(comp, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = same_tree(loaded, merged) and lcfg == cfg
        tok_l, launch_l = _greedy_one(loaded, lcfg)
        expect_launches(launch_l, {"flash_fwd": layers,
                                   "decode_attn": layers * CLI_DECODE},
                        "greedy decode of the trained checkpoint")
        tok_m, _ = _greedy_one(merged, cfg)
        tokens_same = torch.equal(tok_l, tok_m)
        ok = same and tokens_same and in_vocab(tok_l, lcfg)
        print(f"train CLI components: {dir_bytes(comp) / 1e9:.3f} GB "
              f"(llm/, vision_tower/, mm_projector/, config.json) loaded by "
              f"load_pretrained_model in {load_s:.1f} s with the LoRA merge; "
              f"tree == merge_lora of run A's {same}; {CLI_DECODE} greedy "
              f"tokens from it {tok_l.tolist()} == the in-memory merge's "
              f"{tokens_same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train CLI: the component checkpoint "
                                 "differs")
        del loaded, merged
        shutil.rmtree(comp)
        torch.cuda.empty_cache()

        # run B: stopped at 2, resumed to 4
        with _CliProbe(run_lib, ckpt_lib) as probe_b:
            run_lib.train(rcfg("B", 2), None, dataset=ds)  # tree freed
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            run_lib.train(rcfg("B", CLI_STEPS), None, dataset=ds)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        b = _metrics(os.path.join(root, "B", "metrics.jsonl"))
        diff = {k: max(abs(b[s][k] - a[s][k]) for s in (3, 4))
                for k in ("loss", "kl")}
        close = set(b) == set(range(1, CLI_STEPS + 1)) and all(
            abs(b[s][k] - a[s][k]) <= CLI_RTOL * abs(a[s][k])
            for s in (3, 4) for k in ("loss", "kl"))
        with np.load(os.path.join(root, "A", "adapter.npz")) as za, \
                np.load(os.path.join(root, "B", "adapter.npz")) as zb:
            adapter_diff = max(
                float((tree.to_torch(za[k], "cpu").float()
                       - tree.to_torch(zb[k], "cpu").float()).abs().max())
                for k in za.files)
        ok = close
        print(f"train CLI run B: stopped at 2, resumed to {CLI_STEPS} in "
              f"{resume_s:.1f} s (base load, restore, 2 micro-steps, save, "
              f"export); steps 3-4 against run A: largest |loss diff| "
              f"{diff['loss']:.3e}, |kl diff| {diff['kl']:.3e} (rtol "
              f"{CLI_RTOL}); final adapters' largest |A - B| "
              f"{adapter_diff:.3e}; saves "
              + ", ".join(f"step {s} {sec:.2f} s" for s, sec, _ in
                          probe_b.saves)
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train CLI: the resumed run differs from "
                                 "the uninterrupted one")
        print(f"train CLI phase: {time.perf_counter() - t_phase:.1f} s wall")
        if then is not None:
            then(base, cfg)  # a further phase on the same base dir
    finally:
        PRESETS.pop(CLI_PRESET, None)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---- packed DPA (train/pack.py, llava.forward_packed, the packed loss and
# step) and the 8-bit Adam moments (train/optim8bit.py) ---------------------

PACK_TEXT = (96, 512, 256, 96)  # text tokens a document: min, max, mean, sd
PACK_SEED = 34  # every pn row of the first packed batches holds 3 documents
PACK_SAMPLES = 16
PACK_BATCH = 4  # per_device_batch: max_samples of a packed batch
PACK_ROWS, PACK_REF_ROWS = 2, 1
PACK_MAX_LENGTH = 2048  # the CLI's default max_length
# the CLI's default pack_seq_len: r64(max_length + T - 1), 2624 = 41 x 64
PACK_SEQ = -(-(PACK_MAX_LENGTH + LLAVA_V15_7B.num_image_tokens - 1)
             // 64) * 64
PACK_STEPS = 5  # packed micro-steps timed (the first a warm-up)
ADAM8_UPDATES = 8
ADAM8_LR = 1e-4
# 8-bit moments against fp32 moments (the same update code, min_quant_size
# above every leaf) after ADAM8_UPDATES updates of seeded N(0, 1e-3^2)
# grads at lr ADAM8_LR: the relative error of the params' total change.
# Each moment's block code step is absmax/127 (m) or max/255 of sqrt(v),
# ~1 % of a block's RMS, so the direction m / sqrt(v) moves by ~1 % where
# the codes are nonzero, and the few elements of a block whose codes round
# to 0 at the first update take no step. This phase run on the CPU with a
# 2-layer LoRA tree of the same leaf kinds reads 9.1e-3; the bound is about
# three times that.
ADAM8_REL = 0.03


class PackSamples(CliSamples):
    """HallDataset.__getitem__'s samples like CliSamples', with text
    lengths drawn from a seed: N(256, 96) rounded and clipped to 96-512
    (TRAIN7B_PACK.json's 256-token mean texts) for each of pos, neg and ref;
    the image sentinel at 1, labels on the second half, two phrase spans on
    pos and neg."""

    def __init__(self, cfg, n: int = PACK_SAMPLES, seed: int = PACK_SEED):
        lo, hi, mean, sd = PACK_TEXT
        rng = np.random.RandomState(seed)
        lens = np.clip(np.rint(rng.normal(mean, sd, (n, 3))), lo, hi)
        size = cfg.vision.image_size
        vocab = min(30000, cfg.llm.vocab_size)

        def seq(t: int, phrases: bool):
            ids = rng.randint(5, vocab, t).astype(np.int32)
            ids[1] = IMAGE_TOKEN_INDEX
            lab = ids.copy()
            lab[: t // 2] = IGNORE_INDEX
            sg = np.zeros(t, np.int32)
            if phrases:
                sg[t // 2: t // 2 + 3] = 1
                sg[t // 2 + 4: t // 2 + 7] = 2
            return ids, lab, sg

        self.items = []
        for a, b, c in lens.astype(int):
            (i1, l1, g1), (i2, l2, g2), (i3, l3, _) = (
                seq(a, True), seq(b, True), seq(c, False))
            self.items.append(dict(
                input_ids=i1, labels=l1, pos_signs=g1, neg_input_ids=i2,
                neg_labels=l2, neg_signs=g2, ref_input_ids=i3,
                ref_labels=l3,
                image=rng.randn(3, size, size).astype(np.float32),
                ref_image=rng.randn(3, size, size).astype(np.float32)))


def pack_batcher(cfg) -> PackedDPABatcher:
    """The train CLI's batcher at --per-device-batch PACK_BATCH,
    --pack-rows PACK_ROWS, --pack-ref-rows PACK_REF_ROWS and the default
    pack_seq_len."""
    return PackedDPABatcher(
        seq_len=PACK_SEQ, pn_rows=PACK_ROWS, ref_rows=PACK_REF_ROWS,
        max_samples=PACK_BATCH, num_image_tokens=cfg.num_image_tokens,
        pad_token_id=0,
        image_shape=(3, cfg.vision.image_size, cfg.vision.image_size))


def on_card(host: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(DEVICE)
            for k, v in host.items()}


def step_ms(step, trainable, frozen, opt, batch) -> float:
    """One micro-step (the optimizer included), CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    m = step(trainable, frozen, None, opt, batch)[2]
    end.record()
    torch.cuda.synchronize()
    if not all(np.isfinite(float(x)) for x in m):
        raise AssertionError("packed phase: a loss is not finite")
    return start.elapsed_time(end)


def run_pack_steps(params, cfg, kernels: dict, ds, host: list,
                   spans: list, what: str = "", suffix: str = ""):
    """The main path of the phase: a packed micro-step on each batch of
    `host` (AdamW with 8-bit moments, grad_accum 2) with its K1-K3 launches
    (under their names plus `suffix`, the config's head-dim suffix), then
    the unpacked micro-step on each batch's samples (collate pads to the
    longest) for its time."""
    layers = cfg.llm.num_layers
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    policy = add_lora(params, gen, rank=128, alpha=256.0)
    tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400, remat=True,
                       loss_chunk=256, optim="adamw8bit")
    trainable, frozen, opt, _ = init_train_state(policy, tcfg)
    step, _ = packed_dpa_step_fns(cfg, tcfg, opt, max_samples=PACK_BATCH)
    batches = [on_card(h) for h in host]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    seen, packed_ms, total = {}, [], collections.Counter()
    for i, batch in enumerate(batches):
        packed_ms.append(step_ms(step, trainable, frozen, opt, batch))
        now = dict(_kernels.launches)
        per_step = {k: now[k] - seen.get(k, 0) for k in now}
        seen = now
        total.update(per_step)
        expect_launches(per_step, {"flash_fwd" + suffix: 5 * layers,
                                   "flash_bwd_dq" + suffix: 2 * layers,
                                   "flash_bwd_dkv" + suffix: 2 * layers},
                        f"{what}packed train micro-step {i}")
    add_launches(kernels, dict(total))
    del policy, trainable, frozen, opt, step, batches
    torch.cuda.empty_cache()

    policy = add_lora(params, torch.Generator(device=DEVICE).manual_seed(1),
                      rank=128, alpha=256.0)
    trainable, frozen, opt, _ = init_train_state(policy, tcfg)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    unpacked_ms, widths = [], []
    for lo, hi in spans:
        ub = on_card(collate(ds.items[lo:hi], pad_token_id=0))
        widths.append(ub["input_ids"].shape[1] + cfg.num_image_tokens - 1)
        unpacked_ms.append(step_ms(step, trainable, frozen, opt, ub))
    del policy, trainable, frozen, opt, step
    torch.cuda.empty_cache()
    n = [hi - lo for lo, hi in spans]
    pk = statistics.mean(packed_ms[1:])
    un = statistics.mean(unpacked_ms[1:])
    per = statistics.mean(n[1:])
    print(f"{what}packed train main path ({gpu_line()}): "
          f"{pk:.1f} ms per packed micro-step (mean of micro-steps "
          f"1-{len(n) - 1}; all: " + ", ".join(f"{t:.1f}" for t in packed_ms)
          + f" ms, CUDA events) of {PACK_ROWS} + {PACK_REF_ROWS} rows x "
          f"{PACK_SEQ} tokens holding {n} samples: {per / pk * 1e3:.3f} "
          f"samples/s; the unpacked micro-step on the same samples (rows "
          f"padded to {widths} spliced tokens) {un:.1f} ms (all: "
          + ", ".join(f"{t:.1f}" for t in unpacked_ms)
          + f"): {per / un * 1e3:.3f} samples/s; packed / unpacked "
          f"samples/s {un / pk:.3f}x")
    return pk, un


def compare_packed(params, cfg, ds, host0: dict, span,
                   what: str = "") -> None:
    """One packed micro-step against the unpacked micro-step on the same
    samples: loss, alignment, KL and LoRA grads, within TRAIN_FLOOR_FACTOR
    of the noise floor (the unpacked micro-step against itself with the
    text embeddings perturbed, the largest of FLOOR_DRAWS draws)."""
    cmp = comparison_policy(params)
    ub = on_card(collate(ds.items[span[0]:span[1]], pad_token_id=0))
    noise = torch.Generator(device=DEVICE).manual_seed(3)
    runs = {"packed": micro_step_grads(cmp, on_card(host0), cfg,
                                       packed=PACK_BATCH),
            "unpacked": micro_step_grads(cmp, ub, cfg)}
    for i in range(FLOOR_DRAWS):
        runs[f"floor{i}"] = micro_step_grads(cmp, ub, cfg, noise)
    want = runs["unpacked"]

    def errs(got):
        return (abs(got[3] - want[3]) / abs(want[3]),
                abs(got[0] - want[0]) / abs(want[0]),
                abs(got[1] - want[1]) / abs(want[1]),
                rel_err(got[2], want[2]))

    got = errs(runs["packed"])
    draws = [errs(runs[f"floor{i}"]) for i in range(FLOOR_DRAWS)]
    floor = tuple(max(x) for x in zip(*draws))
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) and np.isfinite(
        r[3]) and bool(torch.isfinite(r[2]).all()) for r in runs.values())
    ok = finite and all(e <= TRAIN_FLOOR_FACTOR * f
                        for e, f in zip(got, floor))
    names = ("loss", "alignment", "kl", "LoRA grads")
    print(f"{what}packed vs unpacked micro-step ({span[1] - span[0]} "
          f"samples, lora_b ~ {LORA_B_STD} N(0,1)): unpacked loss "
          f"{want[3]:.6f}, "
          f"alignment {want[0]:.6f}, kl {want[1]:.4e}; packed loss "
          f"{runs['packed'][3]:.6f}, alignment {runs['packed'][0]:.6f}, kl "
          f"{runs['packed'][1]:.4e}; rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, got))
          + "; noise floor (unpacked vs unpacked with the text embeddings x "
          f"(1 + 2^-7 N(0,1)), the largest of {FLOOR_DRAWS} draws) "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, floor))
          + "; the draws: " + "; ".join(
              "/".join(f"{e:.3e}" for e in d) for d in draws)
          + f"; bound {TRAIN_FLOOR_FACTOR:.3f} x floor "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}the packed micro-step disagrees with "
                             "the unpacked one")


def run_adam8(params) -> None:
    """optim8bit on the 7B LoRA tree (r=128 on the 7 linears of every
    layer): ADAM8_UPDATES updates from seeded grads against the same
    updates with fp32 moments, on fp32 copies of the leaves (a bf16 param
    would round these small steps away); the state bytes beside
    torch.optim.AdamW's (bf16 moments, as the train step keeps them); one
    update's device time beside AdamW's on the bf16 leaves."""
    policy = add_lora(params, torch.Generator(device=DEVICE).manual_seed(5),
                      rank=128, alpha=256.0)
    leaves = [t for p, t in tree.flatten(policy)
              if p[-1] in ("lora_a", "lora_b")]
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    for t in leaves:  # lora_b starts at 0: move it off, as training does
        t.add_(torch.randn(t.shape, generator=gen, device=DEVICE).to(
            t.dtype) * 1e-3)
    n = sum(t.numel() for t in leaves)
    p8 = [t.float().clone().requires_grad_(True) for t in leaves]
    pf = [t.float().clone().requires_grad_(True) for t in leaves]
    opt8 = optim8bit.AdamW8bit(p8, lr=ADAM8_LR)
    optf = optim8bit.AdamW8bit(pf, lr=ADAM8_LR, min_quant_size=n + 1)
    for i in range(ADAM8_UPDATES):
        gen = torch.Generator(device=DEVICE).manual_seed(100 + i)
        for a, b in zip(p8, pf):
            a.grad = torch.randn(a.shape, generator=gen, device=DEVICE) * 1e-3
            b.grad = a.grad
        opt8.step()
        optf.step()
    torch.cuda.synchronize()
    num = sum(float((a - b).detach().square().sum())
              for a, b in zip(p8, pf))
    den = sum(float((b.detach() - t.float()).square().sum())
              for b, t in zip(pf, leaves))
    rel = (num / den) ** 0.5
    bytes8 = optim8bit.state_bytes(opt8)
    del p8, pf, opt8, optf
    torch.cuda.empty_cache()

    # one update's device time on the bf16 leaves, each optimizer alone
    def timed(opt_cls, **kw):
        ps = [t.detach().clone().requires_grad_(True) for t in leaves]
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        for p in ps:
            p.grad = (torch.randn(p.shape, generator=gen, device=DEVICE)
                      * 1e-3).to(p.dtype)
        opt = opt_cls(ps, lr=ADAM8_LR, **kw)
        ms = timed_ms(opt.step, iters=5, warmup=1)
        nbytes = optim8bit.state_bytes(opt)
        del ps, opt
        torch.cuda.empty_cache()
        return ms, nbytes

    ms8, _ = timed(optim8bit.AdamW8bit)
    msw, bytesw = timed(torch.optim.AdamW)
    ok = rel <= ADAM8_REL and np.isfinite(rel)
    print(f"8-bit Adam on the 7B LoRA tree ({gpu_line()}): {len(leaves)} "
          f"leaves, {n / 1e6:.1f} M params; after {ADAM8_UPDATES} updates "
          f"(lr {ADAM8_LR}, grads N(0, 1e-3^2) from seeds) the params' "
          f"change against fp32 moments: rel err {rel:.3e} (bound "
          f"{ADAM8_REL}); state {bytes8 / 1e9:.3f} GB "
          f"({bytes8 / n:.3f} bytes a param) against torch.optim.AdamW's "
          f"{bytesw / 1e9:.3f} GB (bf16 moments, {bytesw / n:.3f} bytes a "
          f"param); one update {ms8:.2f} ms of device time against "
          f"AdamW's (foreach) {msw:.2f} ms {'ok' if ok else 'FAIL'}")
    del policy, leaves
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("8-bit Adam strays from fp32 Adam")


def run_pack_cli(base: str, cfg, ds) -> None:
    """The train CLI on the packed path at llava-v1.5-7b's full width and
    CLI_LAYERS depth (`cfg`, registered as CLI_PRESET), from the save_params
    dir `base`: run C, --pack true --optim
    adamw8bit, grad_accum 2, 4 micro-steps, a save every 2; run D, stopped
    at 2 and resumed to 4, whose steps 3-4 and adapter equal C's."""
    from halva_tpu_torch.train import run as run_lib

    root = os.path.dirname(base)
    layers = cfg.llm.num_layers

    def rcfg(out, max_steps):
        return run_lib.RunConfig(
            model=CLI_PRESET, model_path=base,
            output_dir=os.path.join(root, out), per_device_batch=PACK_BATCH,
            grad_accum_steps=2, lora_r=128, lora_alpha=256.0,
            max_steps=max_steps, save_steps=2, pack=True,
            max_length=PACK_MAX_LENGTH, pack_rows=PACK_ROWS,
            pack_ref_rows=PACK_REF_ROWS, optim="adamw8bit", device=DEVICE)

    try:
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with _CliProbe(run_lib, ckpt_lib) as probe:
            run_lib.train(rcfg("C", CLI_STEPS), None, dataset=ds)
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        per_step = {k: v / CLI_STEPS for k, v in _kernels.launches.items()}
        expect_launches(per_step, {"flash_fwd": 5 * layers,
                                   "flash_bwd_dq": 2 * layers,
                                   "flash_bwd_dkv": 2 * layers},
                        "packed train CLI run C, per micro-step")
        c = _metrics(os.path.join(root, "C", "metrics.jsonl"))
        finite = set(c) == set(range(1, CLI_STEPS + 1)) and all(
            np.isfinite(c[s][k]) for s in c for k in ("loss", "kl",
                                                      "grad_norm"))
        dts = [d * 1e3 for d in probe.dts]
        saved_at = {s for s, _, _ in probe.saves}
        clean = [d for i, d in enumerate(dts, 2) if i - 1 not in saved_at]
        print(f"packed train CLI run C ({gpu_line()}): --pack true --optim "
              f"adamw8bit, {CLI_STEPS} micro-steps in {c_s:.1f} s with the "
              f"base load, the saves and the exports; host ms per micro-step "
              "from StepTimer " + ", ".join(f"{d:.1f}" for d in dts)
              + f" (mean without a save: {statistics.mean(clean):.1f}); loss "
              + ", ".join(f"{c[s]['loss']:.6f}" for s in sorted(c))
              + f" {'ok' if finite else 'FAIL'}")
        for step, sec, nbytes in probe.saves:
            print(f"packed train CLI checkpoint save at step {step}: "
                  f"{nbytes / 1e9:.3f} GB (LoRA leaves, 8-bit moments and "
                  f"count, accumulators) in {sec:.2f} s, against AdamW's "
                  "2.559 GB (PR 15)")
        if not finite:
            raise AssertionError("packed train CLI: a metric is missing or "
                                 "not finite")
        run_lib.train(rcfg("D", 2), None, dataset=ds)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run_lib.train(rcfg("D", CLI_STEPS), None, dataset=ds)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        d = _metrics(os.path.join(root, "D", "metrics.jsonl"))
        diff = {k: max(abs(d[s][k] - c[s][k]) for s in (3, 4))
                for k in ("loss", "kl")}
        close = set(d) == set(range(1, CLI_STEPS + 1)) and all(
            abs(d[s][k] - c[s][k]) <= CLI_RTOL * abs(c[s][k])
            for s in (3, 4) for k in ("loss", "kl"))
        with np.load(os.path.join(root, "C", "adapter.npz")) as zc, \
                np.load(os.path.join(root, "D", "adapter.npz")) as zd:
            same = sorted(zc.files) == sorted(zd.files) and all(
                zc[k].tobytes() == zd[k].tobytes() for k in zc.files)
        ok = close and same
        print(f"packed train CLI run D: stopped at 2, resumed to {CLI_STEPS} "
              f"in {resume_s:.1f} s; steps 3-4 against run C: largest |loss "
              f"diff| {diff['loss']:.3e}, |kl diff| {diff['kl']:.3e} (rtol "
              f"{CLI_RTOL}); adapter == run C's {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("packed train CLI: the resumed run differs "
                                 "from the uninterrupted one")
    finally:
        for out in ("C", "D"):
            shutil.rmtree(os.path.join(root, out), ignore_errors=True)


def run_pack(params, cfg, kernels: dict, base: str, cli_cfg) -> list:
    """The packed-train phase on the bf16 tree `params` (llava-v1.5-7b at
    full width and depth): the batcher's first packed batches (3 samples
    and 3 documents a pn row each); K1, K2 and K3 against their plain
    versions on the first one's segment ids, timed; the packed micro-step
    against the unpacked one on the same samples; the main path's launches
    and times; 8-bit Adam on the 7B LoRA tree; the packed train CLI from
    the save_params dir `base` of config `cli_cfg`. Returns the phase's
    rows of K1-K3."""
    t_phase = time.perf_counter()
    ds = PackSamples(cfg)
    batcher = pack_batcher(cfg)
    host = list(itertools.islice(batcher.batches(iter(ds.items)),
                                 PACK_STEPS))
    spans, lo = [], 0
    for h in host:
        spans.append((lo, lo + int(h["n_samples"])))
        lo = spans[-1][1]
    docs = [[int(h["pn_segment_ids"][r].max()) for r in range(PACK_ROWS)]
            for h in host]
    live = [int((h["pn_segment_ids"] != 0).sum()) for h in host]
    ok = (batcher.dropped == 0 and all(b - a >= 3 for a, b in spans)
          and all(min(d) >= 3 for d in docs))
    print(f"packed batches (llava-v1.5-7b, {PACK_ROWS} pn + {PACK_REF_ROWS} "
          f"ref rows x {PACK_SEQ} tokens, <= {PACK_BATCH} samples; text "
          f"lengths N({PACK_TEXT[2]}, {PACK_TEXT[3]}) in "
          f"[{PACK_TEXT[0]}, {PACK_TEXT[1]}] from seed {PACK_SEED}): samples "
          f"per step {[b - a for a, b in spans]}, documents per pn row "
          f"{docs}, live pn tokens {live} of {PACK_ROWS * PACK_SEQ} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a packed batch holds fewer than 3 samples or "
                             "a pn row fewer than 3 documents")

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    seg = torch.from_numpy(host[0]["pn_segment_ids"]).to(DEVICE)
    case = flash_mode_case(gen, "packed rows (the batcher's segment ids)",
                           PACK_ROWS, PACK_SEQ, cfg.llm.num_heads,
                           cfg.llm.kv_heads, None, {}, seg=seg, timed=True)
    rows = []
    for part, name in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"),
                       ("dkv", "flash_bwd_dkv")):
        source, replaces = FLASH_SOURCES[name]
        rows.append({"name": f"{name}_packed", "route": "cuda",
                     "source": source, "replaces": replaces, **case[part]})
        if name in kernels and "max_abs_err" in kernels[name]:
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               case[part]["max_abs_err"])
    torch.cuda.empty_cache()

    compare_packed(params, cfg, ds, host[0], spans[0])
    torch.cuda.empty_cache()
    run_pack_steps(params, cfg, kernels, ds, host, spans)
    run_adam8(params)
    run_pack_cli(base, cli_cfg, ds)
    print(f"packed train phase: {time.perf_counter() - t_phase:.1f} s wall")
    return rows


# ---- the decode variants of the eval path: nucleus sampling in the graph
# loop, and the continuous-batching engine (ops/continuous.py) -------------

SAMPLE_T, SAMPLE_P = 0.7, 0.9  # the sampled runs' temperature and top_p
SAMPLE_SEED = 1234
# the sampled main path: batch 80 (the bench's 128 tokens reduced to 64 for
# the smoke's time limit)
SAMPLE_TOKENS = 64
SAMPLE_SHORT = 32  # the repeat, the other seed, temperature 0 vs greedy
CHI2_ROWS = 4  # full-vocab rows of the sampler's frequency test
CHI2_REPEAT = 1024  # copies of each row a call
CHI2_CALLS = 8  # calls (steps): CHI2_REPEAT * CHI2_CALLS draws a row
CHI2_P = 1e-3
# bench_continuous's workload, its 240 requests reduced to 160 (two drain
# batches) for the smoke's time limit
CB_REQUESTS, CB_CAP = 160, 128
CB_CHUNKS = (16,)  # its default chunk (reduced: chunk 8 no longer run)
CB_FLOOR_ROWS = 16  # rows decoded at a refill's size for the noise floor
CB_RING_ROWS = 16  # rows refilled for the ring-mask step on K4
CB_PREFILL_ROWS = (16, 10, 80)  # the refill sizes at batch 80, and a batch
# a greedy divergence between the engine and the drain must start where the
# drain's top-two margin is within the bf16 noise: a flip needs the two
# logits to move by the margin, and each moves by at most the floor; 4/3 as
# every floor rule of this script
CB_MARGIN_FACTOR = 2 * TRAIN_FLOOR_FACTOR


def add_launches(kernels: dict, launches: dict) -> None:
    """A further main path's counts, added to its kernels' `launches`."""
    for name, n in launches.items():
        kernels[name]["launches"] = kernels[name].get("launches", 0) + n


def run_sampling_bf16(params, cfg) -> None:
    """Briefly on the bf16 tree: generate(temperature=0) is generate_greedy,
    token for token, both from CUDA graphs."""
    inputs = make_inputs(cfg)
    with torch.inference_mode():
        want, _ = generate_greedy(params, cfg, *inputs,
                                  max_new_tokens=SAMPLE_SHORT, eos_id=-1)
        got, _ = generate(params, cfg, *inputs, max_new_tokens=SAMPLE_SHORT,
                          eos_id=-1, temperature=0.0, seed=SAMPLE_SEED)
        sampled, _ = generate(params, cfg, *inputs,
                              max_new_tokens=SAMPLE_SHORT, eos_id=-1,
                              temperature=SAMPLE_T, top_p=SAMPLE_P,
                              seed=SAMPLE_SEED)
    ok = torch.equal(got, want) and in_vocab(sampled, cfg)
    print(f"sampling on the bf16 tree: generate(temperature=0) == "
          f"generate_greedy over {SAMPLE_SHORT} tokens x {got.shape[0]} rows "
          f"{torch.equal(got, want)}; a sampled run (T={SAMPLE_T}, top_p="
          f"{SAMPLE_P}) agrees with greedy on "
          f"{float((sampled == want).float().mean()):.3f} of its tokens "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bf16 tree: temperature 0 is not greedy")


def nucleus_recorder(seen: list):
    """_select_token that also records, for each call, whether every chosen
    token lies in its step's nucleus (eager runs only)."""
    select = generate_mod._select_token

    def recording(logits, temperature, top_p, seed, step):
        tok = select(logits, temperature, top_p, seed, step)
        kept = nucleus_logits(logits, temperature, top_p)
        seen.append(bool(torch.isfinite(kept.gather(1, tok.long()[:, None]))
                         .all()))
        return tok

    return recording


def step_body_ms(params, cfg, prefill, temperature) -> float:
    """Device ms of one decode-loop step at gen slot GRAPH_AT, replayed from
    a CUDA graph, greedy or sampled."""
    first_tok, _, slen, pc, pseg = prefill
    state, bodies = decode_loop(params, cfg, first_tok, slen, pc, pseg,
                                GRAPH_AT + 64, -1, temperature=temperature,
                                top_p=SAMPLE_P, seed=SAMPLE_SEED)
    state.step.fill_(GRAPH_AT)
    return device_ms(bodies[0])


def run_sampling(q4, cfg, kernels: dict) -> None:
    """Nucleus sampling on the int4g tree with int4 prompt KV at batch 80:
    generate() from CUDA graphs as a user calls it (its launches counted);
    the graph loop against its eager body on one prefill, token for token,
    every eager draw inside its step's nucleus; on the 4 requests a seed
    repeats, another differs, temperature 0 is greedy; the sampled step's
    device time beside the greedy step's."""
    layers = cfg.llm.num_layers
    inputs = tuple(t.repeat_interleave(BATCH80 // t.shape[0], dim=0)
                   for t in make_inputs(cfg))
    kw = dict(eos_id=-1, kv_quant="int4")
    sample = dict(temperature=SAMPLE_T, top_p=SAMPLE_P)
    with torch.inference_mode():
        (tok, num), secs, launches = timed_run(lambda: generate(
            q4, cfg, *inputs, max_new_tokens=SAMPLE_TOKENS,
            seed=SAMPLE_SEED, **sample, **kw))
        expect_launches(launches, {
            "flash_fwd": layers, "decode_attn_kv4": layers * SAMPLE_TOKENS,
            **w4_mm_launches(BATCH80, 7 * layers * SAMPLE_TOKENS)},
            f"sampled int4g run at batch {BATCH80}")
        add_launches(kernels, launches)
        prefill = _prefill_impl(q4, cfg, *inputs, kv_quant="int4")
        first_tok, first_logits, slen, pc, pseg = prefill
        seen = []
        first = nucleus_recorder(seen)(first_logits, SAMPLE_T, SAMPLE_P,
                                       SAMPLE_SEED, FIRST_STEP)
        runs = {}
        for graph in (None, False):
            st = {}
            rec = nucleus_recorder(seen) if graph is False else (
                generate_mod._select_token)
            with mock.patch.object(generate_mod, "_select_token", rec):
                runs[graph] = _decode_impl(
                    q4, cfg, first, slen, pc, pseg, SAMPLE_TOKENS, -1,
                    graph=graph, loop_stats=st, seed=SAMPLE_SEED,
                    **sample)[0]
            if st["graph"] is not (graph is None):
                raise AssertionError("sampled loop: wrong graph mode")
        # the short runs on the 4 requests: a seed twice, another seed,
        # temperature 0 and generate_greedy
        few = make_inputs(cfg)
        short = [generate(q4, cfg, *few, max_new_tokens=SAMPLE_SHORT,
                          seed=seed, **sample, **kw)[0]
                 for seed in (SAMPLE_SEED, SAMPLE_SEED, SAMPLE_SEED + 1)]
        zero, _ = generate(q4, cfg, *few, max_new_tokens=SAMPLE_SHORT,
                           temperature=0.0, seed=SAMPLE_SEED, **kw)
        greedy, _ = generate_greedy(q4, cfg, *few,
                                    max_new_tokens=SAMPLE_SHORT, **kw)
        sampled_ms = step_body_ms(q4, cfg, prefill, SAMPLE_T)
        greedy_ms = step_body_ms(q4, cfg, prefill, 0.0)
        del prefill, pc
    same_graph = torch.equal(runs[None], runs[False])
    same_first = torch.equal(tok, runs[None])
    repeats = torch.equal(short[0], short[1])
    differs = not torch.equal(short[2], short[0])
    zero_greedy = torch.equal(zero, greedy)
    in_nucleus = len(seen) == SAMPLE_TOKENS + 1 and all(seen)
    ok = (same_graph and same_first and repeats and differs and zero_greedy
          and in_nucleus and in_vocab(tok, cfg)
          and bool((num == SAMPLE_TOKENS).all()))
    print(f"sampled int4g run at batch {BATCH80} ({gpu_line()}): "
          f"generate(temperature={SAMPLE_T}, top_p={SAMPLE_P}) "
          f"{SAMPLE_TOKENS} tokens (reduced: the bench's 128) x {BATCH80} "
          f"rows in {secs:.3f} s with its "
          f"prefill; graph loop == its eager body {same_graph} (and == "
          f"generate's run on another prefill {same_first}); every eager "
          f"draw in its step's nucleus {in_nucleus} ({len(seen)} steps); "
          f"{SAMPLE_SHORT} tokens x {len(TEXT_LENS)} rows: seed "
          f"{SAMPLE_SEED} repeats {repeats}, seed {SAMPLE_SEED + 1} differs "
          f"{differs}, temperature 0 == generate_greedy "
          f"{zero_greedy}; one step on the device (a CUDA graph, gen slot "
          f"{GRAPH_AT}): sampled {sampled_ms:.3f} ms, greedy "
          f"{greedy_ms:.3f} ms ({sampled_ms - greedy_ms:+.3f} ms for the "
          f"sort, softmax, cumsum and draw over {cfg.llm.vocab_size} "
          f"logits) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sampled decode: a check failed")


def chi2_p(counts: np.ndarray, probs: np.ndarray) -> float:
    """Pearson's chi-square p value of `counts` against `probs`: the tokens
    expected at least 5 times each a bin, the rest of the nucleus one
    bin."""
    from scipy import stats

    expected = probs * counts.sum()
    big = expected >= 5
    small = (~big) & (probs > 0)
    obs = list(counts[big]) + ([counts[small].sum()] if small.any() else [])
    exp = list(expected[big]) + ([expected[small].sum()] if small.any()
                                 else [])
    obs, exp = np.asarray(obs, np.float64), np.asarray(exp, np.float64)
    return float(stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue)


def check_sampler_frequencies(cfg) -> None:
    """The sampler alone on full-vocab logits: per row, the frequencies of
    CHI2_REPEAT * CHI2_CALLS draws against the filtered softmax computed in
    float64, by a chi-square test; no draw outside the nucleus."""
    v = cfg.llm.vocab_size
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rows = torch.randn(CHI2_ROWS, v, generator=gen, device=DEVICE) * 0.5
    for r in range(CHI2_ROWS):  # a peaked head of 64 tokens over the bulk
        idx = torch.randperm(v, generator=gen, device=DEVICE)[:64]
        rows[r, idx] = torch.linspace(4.0, 10.0, 64, device=DEVICE)
    probs = torch.softmax(nucleus_logits(rows, SAMPLE_T, SAMPLE_P).double(),
                          dim=-1).cpu().numpy()
    counts = torch.zeros(CHI2_ROWS, v, dtype=torch.long, device=DEVICE)
    x = rows.repeat_interleave(CHI2_REPEAT, dim=0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for step in range(CHI2_CALLS):
            tok = generate_mod._select_token(x, SAMPLE_T, SAMPLE_P,
                                             SAMPLE_SEED, step)
            counts.scatter_add_(1, tok.long().view(CHI2_ROWS, CHI2_REPEAT),
                                torch.ones(CHI2_ROWS, CHI2_REPEAT,
                                           dtype=torch.long, device=DEVICE))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = counts.cpu().numpy()
    pvals = [chi2_p(counts[r], probs[r]) for r in range(CHI2_ROWS)]
    outside = int(counts[probs == 0].sum())
    nucleus = [(probs[r] > 0).sum() for r in range(CHI2_ROWS)]
    ok = outside == 0 and min(pvals) > CHI2_P
    print(f"sampler frequencies: {CHI2_ROWS} rows of {v} logits, "
          f"{CHI2_REPEAT * CHI2_CALLS} draws a row (T={SAMPLE_T}, top_p="
          f"{SAMPLE_P}; nuclei of {', '.join(str(int(n)) for n in nucleus)} "
          f"tokens) in {secs:.2f} s; chi-square p against the float64 "
          f"filtered softmax " + ", ".join(f"{p:.3g}" for p in pvals)
          + f" (each > {CHI2_P}); draws outside the nucleus {outside} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sampler frequencies differ from the filtered "
                             "softmax")


def margin_recorder(margins: torch.Tensor, logits_out=None):
    """A capturable _select_token for greedy drain runs: argmax, and the
    top-two margin of each row's fp32 logits written at the step's row of
    `margins` (steps, B); `logits_out` (steps, rows, V), when given, takes
    the first rows' logits."""
    select = generate_mod._select_token

    def recording(logits, temperature, top_p, seed, step):
        idx = step.reshape(1).long()
        top = logits.float().topk(2, dim=-1).values
        margins.index_copy_(0, idx, (top[:, 0] - top[:, 1])[None])
        if logits_out is not None:
            logits_out.index_copy_(
                0, idx, logits[:logits_out.shape[1]].float()[None])
        return select(logits, temperature, top_p, seed, step)

    return recording


def drain_with_margins(q4, cfg, ids, images, batch, rows_logits=0):
    """Greedy drain batches of `batch` rows (CB_CAP tokens, CUDA graphs) with
    each token's top-two margin: (tokens (n, cap), margins (n, cap): the
    margin of the logits that chose each token), and the first
    `rows_logits` rows' logits of batch 0 by step (the first token's from
    the prefill at index 0)."""
    n = len(ids)
    toks, margins, first_logits = [], [], []
    kept = None
    prefill = _prefill_impl

    def prefill_rec(*a, **k):
        out = prefill(*a, **k)
        first_logits.append(out[1].float())
        return out

    lens = torch.full((batch,), bench_continuous.PROMPT_LEN,
                      dtype=torch.int32, device=DEVICE)
    for s in range(0, n, batch):
        m = torch.zeros(CB_CAP, batch, device=DEVICE)
        out = None
        if rows_logits and s == 0:
            out = torch.zeros(CB_CAP, rows_logits, cfg.llm.vocab_size,
                              device=DEVICE)
        with mock.patch.object(generate_mod, "_select_token", margin_recorder(m, out)), \
                mock.patch.object(generate_mod, "_prefill_impl", prefill_rec):
            tok, _ = generate_greedy(
                q4, cfg, torch.from_numpy(ids[s:s + batch]).to(DEVICE),
                torch.from_numpy(images[s:s + batch]).to(DEVICE), lens,
                CB_CAP, eos_id=-1, kv_quant="int4")
        top = first_logits[-1].topk(2, dim=-1).values
        # token t was chosen by the prefill (t = 0) or by step t - 1
        m = torch.cat([(top[:, 0] - top[:, 1])[None], m[:-1]])
        toks.append(tok.cpu().numpy())
        margins.append(m.t().cpu().numpy())
        if out is not None:
            kept = torch.cat([first_logits[-1][:rows_logits][None],
                              out[:-1]])  # by token index, as the margins
    return np.concatenate(toks), np.concatenate(margins), kept


def bf16_floor(q4, cfg, ids, images, drain_tok, drain_logits) -> float:
    """The largest |logit| difference between the drain's first
    CB_FLOOR_ROWS rows and the same requests decoded as a batch of
    CB_FLOOR_ROWS (the engine's refill size: the refill's prefill rows and
    another matmul row count), over every token index whose earlier tokens
    agree in both runs."""
    r = CB_FLOOR_ROWS
    tok, _, logits = drain_with_margins(q4, cfg, ids[:r], images[:r], r,
                                        rows_logits=r)
    agree = np.cumprod(tok == drain_tok[:r], axis=1)  # token t agrees
    live = np.concatenate([np.ones((r, 1), bool), agree[:, :-1] == 1], 1)
    diff = (logits - drain_logits).abs().amax(dim=-1).t().cpu().numpy()
    return float(diff[live].max())


def run_continuous_phase(q4, cfg, kernels: dict) -> None:
    """bench_continuous's workload in process on the smoke's int4g tree
    (int4 prompt KV): CB_REQUESTS requests, batch 80, cap 128, at the
    CB_CHUNKS chunks, timed after a warm-up (the first chunk's launches
    counted); that graph run against the engine's own eager run from the
    same global step, token for token; every
    request against the drain (greedy batches of 80, cut to its budget), each
    divergence at a drain margin within the bf16 noise floor; the drain
    timed; one decode step with the ring mask on K4 against the plain
    path."""
    layers = cfg.llm.num_layers
    budgets = bench_continuous.chair_like_budgets(CB_REQUESTS, CB_CAP)
    ids, images = bench_continuous.workload(cfg, CB_REQUESTS)
    reqs = [Request(ids=ids[i], image=images[i], budget=int(budgets[i]))
            for i in range(CB_REQUESTS)]
    runs = {}
    with torch.inference_mode():
        for chunk in CB_CHUNKS:
            eng, out, wall = bench_continuous.run_continuous(
                q4, cfg, ids, images, budgets, BATCH80, CB_CAP, chunk, "int4",
                DEVICE, on_timed=_kernels.reset_launches)
            torch.cuda.synchronize()
            launches = dict(_kernels.launches)
            st = dict(eng.stats)
            expect_launches(launches, {
                "flash_fwd": layers * st["refills"],
                "decode_attn_kv4": layers * st["steps"],
                **w4_mm_launches(BATCH80, 7 * layers * st["steps"])},
                f"continuous run at chunk {chunk}")
            if chunk == CB_CHUNKS[0]:
                add_launches(kernels, launches)
                # the global step the timed run began at (after the
                # warm-up), read before the ring check steps the state on
                start = int(eng.state.global_step) - st["steps"]
                # a state mid-stream: one refill of CB_RING_ROWS slots, one
                # chunk; their rows' valid slots lie in no prefix
                eng._scatter(list(range(CB_RING_ROWS)), *eng._prefill(
                    reqs[:CB_RING_ROWS], CB_RING_ROWS))
                eng._run_chunk()
                ring = ring_step_check(q4, cfg, eng.state)
            runs[chunk] = (out, wall, st, launches)
            del eng
            torch.cuda.empty_cache()
            clock(f"continuous: chunk {chunk}")
        # the engine's own eager run at the first chunk from the global step
        # the graph run began at: the ring's write slots follow the global
        # step (reduced: its state starts there instead of after an eager
        # run of the warm-up; K4 zero-fills the slots it masks, so what the
        # warm-up left in them cannot reach a token)
        t0 = time.perf_counter()
        eager = ContinuousEngine(q4, cfg, batch=BATCH80,
                                 max_new_tokens=CB_CAP, eos_id=-1,
                                 prompt_pad=bench_continuous.PROMPT_LEN,
                                 chunk=CB_CHUNKS[0], kv_quant="int4",
                                 graph=False)
        make_state = eager._make_state

        def state_at_start(pc, seg):
            st_e = make_state(pc, seg)
            st_e.global_step.fill_(start)
            return st_e

        eager._make_state = state_at_start
        out_e = eager.run(reqs)
        eager_s = time.perf_counter() - t0
        del eager
        torch.cuda.empty_cache()
        clock("continuous: the engine's eager run")
        drain_s, nb = bench_continuous.run_drain(
            q4, cfg, ids, images, BATCH80, CB_CAP, "int4", DEVICE)
        drain_tok, drain_margin, drain_logits = drain_with_margins(
            q4, cfg, ids, images, BATCH80, rows_logits=CB_FLOOR_ROWS)
        floor = bf16_floor(q4, cfg, ids, images, drain_tok, drain_logits)
        del drain_logits
        torch.cuda.empty_cache()
        clock("continuous: the drain, its margins and floor")
        prefill_ms = {}
        for rows in CB_PREFILL_ROWS:
            args = [torch.from_numpy(a[:rows]).to(DEVICE) for a in (
                ids, images)]
            lens = torch.full((rows,), bench_continuous.PROMPT_LEN,
                              dtype=torch.int32, device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _prefill_impl(q4, cfg, *args, lens, kv_quant="int4")
            torch.cuda.synchronize()
            prefill_ms[rows] = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
    out16 = runs[CB_CHUNKS[0]][0]
    graph_eager = all(n == ne and np.array_equal(t, te)
                      for (t, n), (te, ne) in zip(out16, out_e))
    drain_ips = nb * BATCH80 / drain_s
    ideal = float(budgets.sum()) / BATCH80
    lines, ok = [], graph_eager and ring
    for chunk, (out, wall, st, launches) in runs.items():
        at_budget = [n for _, n in out] == budgets.tolist()
        equal, worst, diverged = 0, 0.0, []
        for i, (t, n) in enumerate(out):
            d = np.nonzero(t[:n] != drain_tok[i, :n])[0]
            if not len(d):
                equal += 1
                continue
            margin = float(drain_margin[i, d[0]])
            diverged.append(margin)
            worst = max(worst, margin)
        explained = worst <= CB_MARGIN_FACTOR * floor
        ok = ok and at_budget and explained
        per_chunk = {k: round(v / st["chunks"], 1)
                     for k, v in launches.items()}
        emitted = int(budgets.sum())
        lines.append(
            f"chunk {chunk}: {CB_REQUESTS / wall:.3f} imgs/s ({wall:.2f} s), "
            f"{st['steps']} lockstep steps, {st['chunks']} chunks, "
            f"{st['refills']} refills ({st['steps'] - ideal:.1f} steps over "
            f"the sum of budgets / batch), occupancy "
            f"{emitted / (st['steps'] * BATCH80):.3f}, launches per chunk "
            f"{per_chunk}, {CB_REQUESTS / wall / drain_ips:.3f}x the drain; "
            f"rows equal to the drain in full {equal}/{CB_REQUESTS}, "
            f"{len(diverged)} diverge, at drain margins up to {worst:.4f} "
            f"(limit {CB_MARGIN_FACTOR:.3f} x floor {floor:.4f}) "
            f"{'ok' if at_budget and explained else 'FAIL'}")
    print(f"continuous vs drain ({gpu_line()}; int4g, int4 prompt KV, batch "
          f"{BATCH80}, {CB_REQUESTS} requests (reduced: bench_continuous's "
          f"240), cap {CB_CAP}, budgets mean "
          f"{budgets.mean():.1f}, their sum / batch {ideal:.1f} steps): drain "
          f"{drain_ips:.3f} imgs/s ({drain_s:.2f} s for {nb} full-budget "
          f"batches, {nb * CB_CAP} steps); prefill on the host clock "
          + ", ".join(f"{r} rows {ms:.1f} ms ({ms / r:.2f} ms a row)"
                      for r, ms in prefill_ms.items())
          + "; " + "; ".join(lines)
          + f"; the chunk-{CB_CHUNKS[0]} graph run == the engine's eager run "
          f"{graph_eager} (eager {eager_s:.1f} s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("continuous batching: a check failed")


def ring_step_check(q4, cfg, st) -> bool:
    """One decode step on the engine's state with its ring mask, on K4
    against the plain path (copies of the gen cache), beside the noise floor
    (the plain path with its token embeddings perturbed at the bf16
    level)."""
    sg = st.gen_cache["k"].shape[3]
    g = st.global_step.clone()
    valid = _ring_valid(g, st.row_start, sg)
    prefix = (valid.long().cumsum(1) == torch.arange(
        1, sg + 1, device=DEVICE)).sum(1) == valid.sum(1)
    ragged = int((~prefix).sum())
    pos = st.base_len + (g - st.row_start)
    noise = torch.Generator(device=DEVICE).manual_seed(1)
    out = {}
    for run, impl in (("auto", "auto"), ("plain", "plain"),
                      ("floor", "plain")):
        gen = {k: v.clone() for k, v in st.gen_cache.items()}
        emb = perturbed(llama.embed(q4["llm"], st.cur[:, None]),
                        noise if run == "floor" else None)
        _kernels.reset_launches()
        out[run], _ = llama.decode_step(
            q4["llm"], cfg.llm, emb, pos, st.prompt_cache, st.prompt_seg,
            gen, g, attn_impl=impl, gen_valid_override=valid,
            write_slot=torch.remainder(g, sg))
        if run == "auto" and not _kernels.launches.get("decode_attn_kv4"):
            raise AssertionError("ring step: K4 did not run")
        del gen
    rel = rel_err(out["auto"], out["plain"])
    floor = rel_err(out["floor"], out["plain"])
    ok = ragged > 0 and rel <= LOGITS_REL_W4
    print(f"ring validity on K4: one decode step at global step {int(g)} "
          f"with the engine's ring mask ({ragged} of {valid.shape[0]} rows "
          f"valid in no prefix), kernel vs plain path logits rel err "
          f"{rel:.3e} (limit {LOGITS_REL_W4}; noise floor {floor:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def run_serve_variants(q4, kernels: dict) -> None:
    cfg = LLAVA_V15_7B
    t0 = time.perf_counter()
    run_sampling(q4, cfg, kernels)
    torch.cuda.empty_cache()
    clock("serve variants: sampling")
    check_sampler_frequencies(cfg)
    torch.cuda.empty_cache()
    clock("serve variants: the sampler's chi-square")
    run_continuous_phase(q4, cfg, kernels)
    torch.cuda.empty_cache()
    print(f"serve variants phase: {time.perf_counter() - t0:.1f} s wall")


# ---- Gemma-2B: the head-dim-256 instances of K1, K4 and K5, and VILA's
# llava_gemma served at full width and depth (18 layers)

GEMMA_WALK_BYTES = 200e6  # caches a kernel timing walks: 4x the L2
GEMMA_SDPA_LAYERS = 4  # layers the SDPA yardstick walks (8x the keys read)
K1_SOURCE = "halva_tpu_torch/csrc/flash_fwd.cu"
K1_REPLACES = "halva_tpu/ops/flash_attention.py:83"
K4_SOURCE = "halva_tpu_torch/csrc/decode_attn.cu"
K4_REPLACES = "halva_tpu/ops/decode_attention.py:82"
K4_NAMES = {"bf16": "decode_attn", "kv8": "decode_attn_kv8",
            "kv4": "decode_attn_kv4"}


def walk_layers(layer_bytes: int) -> int:
    """Distinct caches a timing walks, so that each call reads its own from
    device memory and not from the 50 MB L2 (a Gemma layer's caches are a
    few MB: its one kv head)."""
    return max(2, -(-int(GEMMA_WALK_BYTES) // int(layer_bytes)))


def kernel_row(name, source, replaces, err, ms, plain_ms, lib_ms, lim):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, **lim}


def check_gemma_flash(gen: torch.Generator) -> dict:
    """K1 at head dim 256 against flash_attention_plain at Gemma-2B's
    prefill shape (B=4 rows of PROMPT_LENS, H=8 over KVH=1), o and LSE,
    timed beside SDPA (the kv head repeated outside the timed call)."""
    llm = GEMMA_2B
    b, s = len(PROMPT_LENS), max(PROMPT_LENS)
    h, kvh, d = llm.num_heads, llm.kv_heads, llm.head_size

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v = r(b, s, h, d), r(b, s, kvh, d), r(b, s, kvh, d)
    seg = lengths_to_seg(PROMPT_LENS, s, "cuda")
    o, lse = flash_attention_fwd(q, k, v, seg, seg)
    want = flash_attention_plain(q, k, v, seg, seg)
    live = seg != 0
    tag = f"B={b} S={s} H={h} KVH={kvh} D={d} causal"
    err = held(f"flash_fwd_d256 {tag}", o[live], want[live])
    kr, vr = (t.repeat_interleave(h // kvh, dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * d**-0.5
    mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
            & torch.ones(s, s, dtype=torch.bool, device="cuda").tril())
    want_lse = logits.masked_fill(~mask[:, None], -1e30).logsumexp(-1)
    del logits
    live_h = live[:, None, :].expand(b, h, s)
    lse_err = max_abs(lse[live_h], want_lse[live_h])
    print(f"flash_fwd_d256 {tag}: lse_err {lse_err:.3e} (limit "
          f"{LSE_MAX_ABS}) {'ok' if lse_err <= LSE_MAX_ABS else 'FAIL'}")
    if lse_err > LSE_MAX_ABS:
        raise AssertionError("flash_fwd_d256: LSE disagrees with the plain "
                             "log-sum-exp")
    args = (q, k, v, seg, seg)
    ms = device_ms(lambda: flash_attention_fwd(*args))
    plain_ms = device_ms(lambda: flash_attention_plain(*args))
    flops = 4 * h * d * sum(n * (n + 1) / 2 for n in PROMPT_LENS)
    qt, kt, vt = q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None]))
    lim = bound(tensor_bytes(q, k, v, seg, o, lse), flops)
    print(f"flash_fwd_d256 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA with the mask {lib_ms:.4f} ms, bound "
          f"{lim['bound_ms']:.4f} ms by {lim['bound_by']}; "
          f"{flops / ms / 1e9:.1f} TFLOP/s on live causal pairs; "
          f"{k1_plan(b, s, s, h, d)}")
    return kernel_row("flash_fwd_d256", K1_SOURCE, K1_REPLACES, err, ms,
                      plain_ms, lib_ms, lim)


def _sdpa_walk(qt, kcat, vcat, mask, h):
    """One SDPA call a layer over the first GEMMA_SDPA_LAYERS layers of
    concatenated keys, the kv head repeated to the H query heads outside
    the timed call: ms a layer."""
    n = min(GEMMA_SDPA_LAYERS, kcat.shape[0])
    kr = kcat[:n].repeat_interleave(h // kcat.shape[2], dim=2)
    vr = vcat[:n].repeat_interleave(h // vcat.shape[2], dim=2)

    def walk():
        for li in range(n):
            F.scaled_dot_product_attention(qt, kr[li], vr[li],
                                           attn_mask=mask)

    ms = device_ms(walk) / n
    del kr, vr
    return ms


def check_gemma_decode(gen: torch.Generator) -> list:
    """K4 at head dim 256 against decode_attend_plain at Gemma-2B's decode
    shape (B=4, H=8 over KVH=1, Sp=623, Sg=128) in its bf16, int8/int8 and
    int4/int8 modes, and its beam mode (4 beams) on bf16 and int4 prompt
    caches (decode_rows)."""
    return decode_rows(gen, GEMMA_2B, PROMPT_LENS,
                       (("bf16", 1), ("kv8", 1), ("kv4", 1), ("bf16", BEAMS),
                        ("kv4", BEAMS)), "_d256")


def decode_rows(gen: torch.Generator, llm, lens, cases,
                row_tag: str, sg: int = 128, live=None) -> list:
    """K4 against decode_attend_plain at `llm`'s heads over prompt caches of
    the spliced lengths `lens` (Sp their largest) and a gen cache of `sg`
    slots (each row at a random gen step, or every row at step `live`), in
    each (cache mode, beams) of `cases`; each timed over distinct layers'
    caches beside its bound and, on bf16 caches, SDPA over the concatenated
    keys. Returns rows named K4's counter + `row_tag`."""
    b, h, kvh, d = len(lens), llm.num_heads, llm.kv_heads, llm.head_size
    sp = max(lens)
    seg = lengths_to_seg(lens, sp, "cuda")
    out = []
    for mode, k in cases:
        rows = b * k
        name = K4_NAMES[mode] + ("_beam" if k > 1 else "") + row_tag
        steps = torch.randint(0, sg, (rows,), generator=gen, device="cuda")
        steps[0] = 0
        if live is not None:
            steps.fill_(live)
        gen_valid = torch.arange(sg, device="cuda")[None, :] <= steps[:, None]
        prow = _cache_row_bytes(mode, kvh, d, True)
        grow = _cache_row_bytes(mode, kvh, d, False)
        layers = walk_layers(b * sp * prow + rows * sg * grow)
        pc, gc = _fold_caches(gen, mode, layers, b, rows, kvh, sp, sg, d)
        q = torch.randn(rows, 1, h, d, generator=gen, device="cuda").bfloat16()

        def call(fn, li, **kw):
            return fn(q, {n: t[li] for n, t in pc.items()}, seg,
                      {n: t[li] for n, t in gc.items()}, gen_valid,
                      beam_k=k, **kw)

        kern = functools.partial(call, decode_attend_layer,
                                 **({"beam_route": "grid"} if k > 1 else {}))
        plain = functools.partial(call, decode_attend_plain)
        tag = f"B={rows} H={h} KVH={kvh} Sp={sp} Sg={sg} D={d}"
        err = max(held(f"{name} {tag} layer {li}", kern(li), plain(li))
                  for li in (0, layers - 1))
        ms = device_ms(lambda: [kern(li) for li in range(layers)]) / layers
        plain_ms = device_ms(
            lambda: [plain(li) for li in range(layers)]) / layers
        # the same call on one split (no merge), printed beside the plan's
        one_ms = device_ms(lambda: [kern(li, splits=1)
                                    for li in range(layers)]) / layers
        live_prompt = sum(lens)
        live_gen = int((steps + 1).sum())
        # every query row meets every live key of its item (and beam); the
        # prompt is read once per item
        flops = 4 * d * h * (k * live_prompt + live_gen)
        lim = bound(live_prompt * prow + live_gen * grow
                    + 2 * tensor_bytes(q) + tensor_bytes(seg, gen_valid),
                    flops)
        lib_ms = None
        if mode == "bf16":
            kcat = torch.cat([pc["k"].repeat_interleave(k, dim=1), gc["k"]],
                             dim=3)
            vcat = torch.cat([pc["v"].repeat_interleave(k, dim=1), gc["v"]],
                             dim=3)
            mask = torch.cat([(seg != 0).repeat_interleave(k, dim=0),
                              gen_valid], dim=1)[:, None, None, :]
            lib_ms = _sdpa_walk(q.transpose(1, 2), kcat, vcat, mask, h)
            del kcat, vcat
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"{name} time ({k4_plan(rows, kvh, sp, sg)}; {layers} layers' "
              f"caches walked): kernel {ms:.4f} ms ({one_ms:.4f} ms on one "
              f"split), plain {plain_ms:.4f} ms, SDPA over concatenated keys "
              f"{lib}, bound {lim['bound_ms']:.4f} ms by {lim['bound_by']}")
        out.append(kernel_row(name, K4_SOURCE, K4_REPLACES, err, ms,
                              plain_ms, lib_ms, lim))
        del pc, gc
        torch.cuda.empty_cache()
    return out


FOLD_CASES = (("bf16", False), ("kv4", False), ("bf16", True),
              ("kv4", True))  # (prompt cache mode, shared gen stage)


def check_gemma_fold(gen: torch.Generator) -> list:
    """K5 at head dim 256 against fold_attend_plain at Gemma-2B's beam and
    verify shapes (B=4 items, K=4: 32 query rows an item, two chunks; Sp=623,
    Sg=128), in each of FOLD_CASES (fold_rows)."""
    return fold_rows(gen, GEMMA_2B, PROMPT_LENS, FOLD_CASES, "_d256")


def fold_rows(gen: torch.Generator, llm, lens, cases, row_tag: str) -> list:
    """K5 against fold_attend_plain at `llm`'s heads over prompt caches of
    the spliced lengths `lens` (B items, K=BEAMS queries an item, Sp their
    largest, Sg=128), in each (cache mode, shared) of `cases`: the per-beam
    gen stage, or the shared gen stage with candidates; each also against
    fold_attend_split_plain under its plan, and timed as decode_rows.
    Returns rows named K5's counter + `row_tag`."""
    b, h, kvh, d = len(lens), llm.num_heads, llm.kv_heads, llm.head_size
    sp, sg, k = max(lens), 128, BEAMS
    seg = lengths_to_seg(lens, sp, "cuda")
    out = []
    for mode, shared in cases:
        name = ("fold_attn" + MODE_SUFFIX[mode]
                + ("_shared" if shared else "") + row_tag)
        gen_rows = b if shared else b * k
        if shared:
            gen_len = torch.tensor([0, 37, 100, sg - k], device="cuda")
            gen_valid = (torch.arange(sg, device="cuda")[None, :]
                         < gen_len[:, None])
            live_gen = int(gen_len.sum())
        else:
            steps = torch.randint(0, sg, (gen_rows,), generator=gen,
                                  device="cuda")
            steps[0] = 0
            gen_valid = (torch.arange(sg, device="cuda")[None, :]
                         <= steps[:, None])
            live_gen = int((steps + 1).sum())
        prow = _cache_row_bytes(mode, kvh, d, True)
        grow = _cache_row_bytes(mode, kvh, d, False)
        layers = walk_layers(b * sp * prow + gen_rows * sg * grow)
        pc, gc = _fold_caches(gen, mode, layers, b, gen_rows, kvh, sp, sg, d)
        q = torch.randn(b, k, h, d, generator=gen, device="cuda").bfloat16()
        cand = None
        if shared:
            cand = tuple(torch.randn(b, k, kvh, d, generator=gen,
                                     device="cuda").bfloat16()
                         for _ in range(2))

        def call(fn, li, **kw):
            return fn(q, {n: t[li] for n, t in pc.items()}, seg,
                      {n: t[li] for n, t in gc.items()}, gen_valid,
                      fold_k=k, shared_gen=shared, candidates=cand, **kw)

        plan = fold_plan(b, kvh, k * h // kvh, h // kvh, sp, sg,
                         sm_count(torch.device("cuda")), shared)
        tag = f"B={b} K={k} H={h} KVH={kvh} Sp={sp} Sg={sg} D={d}"
        err = max(held(f"{name} {tag} layer {li}",
                       call(fold_attend_layer, li),
                       call(fold_attend_plain, li))
                  for li in (0, layers - 1))
        err = max(err, held(f"{name} {tag} vs its split plain version",
                            call(fold_attend_layer, 0),
                            call(fold_attend_split_plain, 0, plan=plan)))
        ms = device_ms(lambda: [call(fold_attend_layer, li)
                                for li in range(layers)]) / layers
        plain_ms = device_ms(lambda: [call(fold_attend_plain, li)
                                      for li in range(layers)]) / layers
        one_ms = device_ms(lambda: [call(fold_attend_layer, li, splits=1)
                                    for li in range(layers)]) / layers
        live_prompt = sum(lens)
        if shared:  # query i also meets candidates j <= i
            flops = 4 * d * h * (k * (live_prompt + live_gen)
                                 + b * k * (k + 1) // 2)
        else:
            flops = 4 * d * h * (k * live_prompt + live_gen)
        lim = bound(live_prompt * prow + live_gen * grow
                    + 2 * tensor_bytes(q) + tensor_bytes(seg, gen_valid)
                    + (tensor_bytes(*cand) if shared else 0), flops)
        lib_ms = None
        if mode == "bf16":
            reps = 1 if shared else k  # the prompt of the row's item
            rows, queries = (b, k) if shared else (b * k, 1)
            parts_k = [pc["k"].repeat_interleave(reps, dim=1), gc["k"]]
            parts_v = [pc["v"].repeat_interleave(reps, dim=1), gc["v"]]
            masks = [(seg != 0).repeat_interleave(reps, dim=0)[:, None, :]
                     .expand(rows, queries, sp),
                     gen_valid[:, None, :].expand(rows, queries, sg)]
            if shared:
                parts_k.append(cand[0].transpose(1, 2)[None].expand(
                    layers, b, kvh, k, d))
                parts_v.append(cand[1].transpose(1, 2)[None].expand(
                    layers, b, kvh, k, d))
                masks.append(torch.ones(k, k, dtype=torch.bool,
                                        device="cuda").tril()[None]
                             .expand(b, k, k))
            qt = q.reshape(rows, queries, h, d).transpose(1, 2)
            lib_ms = _sdpa_walk(qt, torch.cat(parts_k, dim=3),
                                torch.cat(parts_v, dim=3),
                                torch.cat(masks, dim=2)[:, None], h)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        plan_text = k5_plan(b, kvh, k * h // kvh, h // kvh, sp, sg, shared)
        print(f"{name} time ({plan_text}; {layers} layers' caches walked): "
              f"kernel {ms:.4f} ms ({one_ms:.4f} ms on one split), plain "
              f"{plain_ms:.4f} ms, SDPA over "
              f"concatenated keys {lib}, bound {lim['bound_ms']:.4f} ms by "
              f"{lim['bound_by']}")
        out.append(kernel_row(name, FOLD_SOURCE, FOLD_REPLACES, err, ms,
                              plain_ms, lib_ms, lim))
        del pc, gc
        torch.cuda.empty_cache()
    return out


GEMMA_BWD_WINDOW = 256  # the window of the mode K2 and K3 at 256 also run
GEMMA_PACK_STEPS = 2  # packed Gemma micro-steps: one update at grad_accum 2
ROUTE_ROUNDS = 1  # rounds of the by-route micro-step timing (reduced from 2)


def pack_segments(cfg) -> torch.Tensor:
    """The pn segment ids of the packed batcher's first batch of `cfg`'s
    samples: 2 rows of PACK_SEQ tokens, 3 documents a row."""
    host = next(pack_batcher(cfg).batches(iter(PackSamples(cfg).items)))
    return torch.from_numpy(host["pn_segment_ids"]).to(DEVICE)


def check_gemma_flash_bwd(gen: torch.Generator) -> list:
    """K2 and K3 at head dim 256 against flash_attention_bwd_plain and
    flash_attention_bwd_tiled_plain (on K1's o and LSE at 256) at Gemma-2B's
    train shape: the pn forward's B=4 rows of TRAIN_SPLICED tokens, H=8
    over KVH=1, causal, every token live (the train batch's segment ids);
    on the packed batcher's rows (2 x PACK_SEQ, 3 documents a row); in the
    window mode; their bitwise repeats and CUDA-graph replays. Each timed
    (median of 20 graph replays) beside the plain backward and SDPA's
    backward, the bound from this run's live pairs. Returns the rows of
    flash_bwd_dq_d256 and flash_bwd_dkv_d256: the train shape's times, the
    largest error of the three cases."""
    llm = GEMMA_2B
    h, kvh, d = llm.num_heads, llm.kv_heads, llm.head_size
    s = TRAIN_SPLICED
    window = {"sliding_window": GEMMA_BWD_WINDOW}
    cases = [
        flash_mode_case(gen, "Gemma-2B pn rows", 4, s, h, kvh, (s,) * 4, {},
                        timed=True, d=d, tiled=True),
        flash_mode_case(gen, "Gemma-2B packed rows (the batcher's segment "
                        "ids)", PACK_ROWS, PACK_SEQ, h, kvh, None, {},
                        seg=pack_segments(LLAVA_GEMMA_2B), timed=True, d=d),
        flash_mode_case(gen, "Gemma-2B window, padded rows", 4, s, h, kvh,
                        (s, s - 7, s - 64, s - 301), window, d=d,
                        tiled=True)]
    torch.cuda.empty_cache()
    check_flash_bwd_repeat(gen, h, kvh, d, ({}, window))
    rows = []
    for part, kernel in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        source, replaces = FLASH_SOURCES[kernel]
        row = dict(cases[0][part])
        row["max_abs_err"] = max(c[part]["max_abs_err"] for c in cases)
        rows.append({"name": kernel + head_dim_suffix(d), "route": "cuda",
                     "source": source, "replaces": replaces, **row})
    return rows


def gemma_kernel_checks(gen: torch.Generator) -> list:
    """The head-dim-256 rows of the `kernels` line."""
    return [check_gemma_flash(gen), *check_gemma_flash_bwd(gen),
            *check_gemma_decode(gen), *check_gemma_fold(gen)]


def route_step_ms(params, cfg, what: str) -> None:
    """One DPA micro-step of run_train's recipe (the optimizer included,
    host clock to a synchronize) on the kernel route and on the plain route
    (attn_impl="plain": the plain attention forward and autograd's backward
    through it), each warmed up once, then timed ROUTE_ROUNDS times in
    turns plain, kernel, kernel, plain: the median of each route, and the
    peak memory of its timed steps (both routes' LoRA and optimizer states
    resident)."""
    batch = train_batch(cfg, 0)
    steps, peak, ms = {}, {}, collections.defaultdict(list)
    for impl in ("auto", "plain"):
        policy = add_lora(params, torch.Generator(device=DEVICE)
                          .manual_seed(1), rank=128, alpha=256.0)
        tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400,
                           remat=True, loss_chunk=256, attn_impl=impl)
        trainable, frozen, opt, opt_state = init_train_state(policy, tcfg)
        steps[impl] = [dpa_step_fns(cfg, tcfg, opt)[0], trainable, frozen,
                       opt_state]
        peak[impl] = 0

    def once(impl):
        step, trainable, frozen, opt_state = steps[impl]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainable, opt_state, _ = step(trainable, frozen, None, opt_state,
                                       batch)
        torch.cuda.synchronize()
        steps[impl] = [step, trainable, frozen, opt_state]
        return (time.perf_counter() - t0) * 1e3

    for impl in ("plain", "auto"):
        once(impl)
    for impl in ("plain", "auto", "auto", "plain") * ROUTE_ROUNDS:
        ms[impl].append(once(impl))
        peak[impl] = max(peak[impl], torch.cuda.max_memory_allocated())
    del steps
    torch.cuda.empty_cache()
    kern = statistics.median(ms["auto"])
    plain = statistics.median(ms["plain"])
    print(f"{what}train micro-step by route ({gpu_line()}; {ROUTE_ROUNDS} "
          "rounds of turns plain, kernel, kernel, plain after a warm-up of "
          "each; medians): kernel route "
          f"{kern:.1f} ms ({', '.join(f'{t:.1f}' for t in ms['auto'])}), "
          f"peak memory {peak['auto'] / 2**30:.2f} GiB; plain route "
          f"{plain:.1f} ms ({', '.join(f'{t:.1f}' for t in ms['plain'])}), "
          f"peak memory {peak['plain'] / 2**30:.2f} GiB; plain / kernel "
          f"{plain / kern:.2f}x")


def run_gemma_train(params, kernels: dict) -> None:
    """LLaVA-Gemma-2B's DPA LoRA train step on its bf16 tree `params`:
    run_train's recipe (LoRA r=128 on the 7 linears, remat, loss_chunk 256
    over the 256,000-row tied table, 4 micro-steps at grad_accum 2), each
    micro-step asserting 5 launches a layer of K1 at 256 and 2 each of K2
    and K3 at 256, then one micro-step against the plain route within 4/3
    of its noise floor; the micro-step's time and peak memory on each route
    (`route_step_ms`); then the packed step: the packed batcher's first
    GEMMA_PACK_STEPS batches (3 documents a pn row) through
    packed_dpa_step_fns (8-bit Adam moments) with the same launches
    asserted, one packed micro-step against the unpacked one on the same
    samples (compare_packed), and the unpacked step on each batch's samples
    for its time."""
    cfg = LLAVA_GEMMA_2B
    what = "llava-gemma-2b "
    t0 = time.perf_counter()
    run_train(params, kernels, cfg, what=what, suffix="_d256")
    torch.cuda.empty_cache()
    route_step_ms(params, cfg, what)
    ds = PackSamples(cfg)
    host = list(itertools.islice(pack_batcher(cfg).batches(iter(ds.items)),
                                 GEMMA_PACK_STEPS))
    spans, lo = [], 0
    for batch in host:
        spans.append((lo, lo + int(batch["n_samples"])))
        lo = spans[-1][1]
    compare_packed(params, cfg, ds, host[0], spans[0], what)
    torch.cuda.empty_cache()
    run_pack_steps(params, cfg, kernels, ds, host, spans, what, "_d256")
    print(f"{what}train phase: {time.perf_counter() - t0:.1f} s")


def family_step_times(params, cfg, kv_quant, tokens, model: str) -> None:
    """Device ms, from CUDA-graph replays at gen slot 8, of one greedy, one
    4-beam and one draft_k-4 verify step on the kernel route and on the
    plain route (attn_impl="plain": the plain attention and, on the int4g
    tree, the plain int4 matmuls) over one prompt cache."""
    inputs = make_inputs(cfg)
    b, at = inputs[0].shape[0], 8
    llm = params["llm"]
    times = {}
    with torch.inference_mode():
        _, _, slen, pc, pseg = _prefill_impl(params, cfg, *inputs,
                                             kv_quant=kv_quant)
        for impl in ("auto", "plain"):
            for kind, k in (("greedy", 1), ("beam", BEAMS)):
                gen_cache = init_gen_cache_like(cfg.llm, b * k, NEW_TOKENS,
                                                pc)
                emb = llama.embed(llm, tokens[:, at, None]
                                  .repeat_interleave(k, dim=0))
                pos = (slen + at).repeat_interleave(k)
                times[kind, impl] = device_ms(lambda: llama.decode_step(
                    llm, cfg.llm, emb, pos, pc, pseg, gen_cache, at,
                    attn_impl=impl, beam_k=k), iters=step_iters(impl))
                del gen_cache
            gen_cache = init_gen_cache_like(cfg.llm, b, NEW_TOKENS, pc)
            emb = llama.embed(llm, tokens[:, at:at + 4])
            gen_len = torch.full((b,), at, dtype=torch.int32, device=DEVICE)
            times["verify", impl] = device_ms(lambda: llama.verify_step(
                llm, cfg.llm, emb, slen + at, pc, pseg, gen_cache, gen_len,
                attn_impl=impl), iters=step_iters(impl))
            del gen_cache
        hidden = llama.embed(llm, tokens[:, at, None])
        times["lm_logits"] = device_ms(lambda: llama.lm_logits(
            llm, cfg.llm, hidden))
        del pc
    what = "int4g, int4 KV" if kv_quant else "bf16"
    tied = "tied " if cfg.llm.tie_word_embeddings else ""
    print(f"{model} {what} step device time (CUDA graphs, gen slot "
          f"{at}, B={b}; the plain route reduced to {PLAIN_STEP_ITERS} "
          f"replays; {gpu_line()}): "
          + "; ".join(f"{kind} {times[kind, 'auto']:.3f} ms on the kernel "
                      f"route, {times[kind, 'plain']:.3f} ms plain "
                      f"({times[kind, 'plain'] / times[kind, 'auto']:.2f}x)"
                      for kind in ("greedy", "beam", "verify"))
          + f"; of a greedy step, the {tied}head (lm_logits over "
          f"{cfg.llm.vocab_size} tokens) {times['lm_logits']:.3f} ms")


def run_family_variants(params, cfg, model: str, kernels: dict, kv_quant,
                        tag: str = "") -> None:
    """On one tree of `cfg`: 4 beams over NEW_TOKENS on the route
    beam_route="auto" takes, a short run on the other route, and
    speculative decode at draft_k 4 over NEW_TOKENS, each through its entry
    point with its launches asserted; on the int4g tree the layer matmuls
    at B*K rows go to K7 by the row rule. With `tag`, the main runs' counts
    go to the rows of `tag` (record)."""
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    b = inputs[0].shape[0]
    suffix = {False: "", "int8": "_kv8", "int4": "_kv4"}[kv_quant]
    dim = head_dim_suffix(cfg.llm.head_size)
    w4 = "kernel_q4p" in params["llm"]["layers"]["attn"]["wq"]
    what = f"{model} {'int4g, int4 KV' if w4 else 'bf16'}"
    n = NEW_TOKENS

    def want(attn: str, count: int, rows: int, steps: int) -> dict:
        out = {"flash_fwd" + dim: layers, attn: count}
        if w4:
            out.update(w4_mm_launches(rows, 7 * layers * steps))
        return out

    with torch.inference_mode():
        main, other_route, other = beam_routes(params, cfg, inputs, kv_quant,
                                               suffix)
        stats = {}
        (tok, num), secs, launches = timed_run(lambda: generate_beam(
            params, cfg, *inputs, max_new_tokens=n, eos_id=-1,
            num_beams=BEAMS, kv_quant=kv_quant, stats=stats))
        expect_launches(launches, want(main, layers * n, b * BEAMS, n),
                        f"{what} beam run ({BEAMS} beams, {n} tokens)")
        record(kernels, launches, *(launches if tag else [main]), tag=tag)
        ok = (in_vocab(tok, cfg) and bool((num == n).all())
              and bool(torch.isfinite(stats["best_scores"]).all())
              and stats["steps"] == n)
        print(f"{what} beam run: {secs:.3f} s with its prefill, best scores "
              + ", ".join(f"{x:.3f}" for x in stats["best_scores"].tolist())
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} beam run: bad hypotheses or scores")
        (tok_o, _), _, launches = timed_run(lambda: generate_beam(
            params, cfg, *inputs, max_new_tokens=SHORT_TOKENS, eos_id=-1,
            num_beams=BEAMS, kv_quant=kv_quant, beam_route=other_route))
        expect_launches(launches, want(other, layers * SHORT_TOKENS,
                                       b * BEAMS, SHORT_TOKENS),
                        f"{what} beam run on the {other_route} route")
        record(kernels, launches, other, tag=tag)
        if not in_vocab(tok_o, cfg):
            raise AssertionError(f"{what}: {other_route}-route beam tokens "
                                 "out of range")
        spec = "fold_attn" + suffix + "_shared" + dim
        (tok_s, num_s, st), secs, launches = timed_run(
            lambda: generate_speculative(params, cfg, *inputs,
                                         max_new_tokens=n, eos_id=-1,
                                         draft_k=4, kv_quant=kv_quant))
        steps = st["verify_steps"]
        expect_launches(launches, want(spec, layers * steps, b * 4, steps),
                        f"{what} speculative run (draft_k 4)")
        record(kernels, launches, spec, tag=tag)
        ok = (in_vocab(tok_s, cfg) and bool((num_s == n).all())
              and st["emitted_tokens"] >= steps >= 1)
        print(f"{what} speculative run: {st}, {secs:.3f} s with its prefill "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} speculative run: bad tokens or "
                                 "stats")


def run_gemma(kernels: dict) -> None:
    """LLaVA-Gemma-2B at full width and depth from a seeded random bf16
    tree, then its int4g tree with int4 prompt KV (and briefly int8 KV):
    greedy decode of the 4 requests through `generate` against the plain
    route within 4/3 of a noise floor, 4 beams, speculative decode at
    draft_k 4, each graph loop against its eager body (`run_graph_loops`:
    greedy, 4 beams, verify at draft_k 4 and 8, and on int4g greedy at
    batch 80), and the step times
    on the kernel route beside the plain route's; on the bf16 tree, before
    it is quantized, the DPA train step unpacked and packed
    (`run_gemma_train`). K1: 18 launches a prefill, 90 a train micro-step;
    K2 and K3: 36 each a micro-step; K4: 18 a token; K6: 7 x 18 = 126 an
    int4g token. The launch counts recorded are the head-dim-256 kernels';
    K6 and K7 are asserted here and keep the llava rows' counts."""
    cfg = LLAVA_GEMMA_2B
    llm = cfg.llm
    layers = llm.num_layers
    w4_route = ("K6/K7" if llama._w4_mm("auto", llm.head_size)
                is w4_matmul.w4_decode_matmul else "plain")
    print(f"route: attn_impl='auto' at Gemma's head dim {llm.head_size} -> "
          f"{kernel_route('auto', llm.head_size)} (serving, and training: "
          "K1 forward, K2 and K3 backward at 256); the packed-int4 decode "
          f"matmuls -> {w4_route}")
    t0 = time.perf_counter()
    params = new_tree(cfg, "llava-gemma-2b (VILA's llava_gemma: Gemma-2B "
                      "under CLIP ViT-L/14-336)")
    tokens = run_family_serving(params, cfg, "llava-gemma-2b bf16", kernels,
                                "flash_fwd_d256", "decode_attn_d256")
    run_family_variants(params, cfg, "llava-gemma-2b", kernels, False)
    family_step_times(params, cfg, False, tokens, "llava-gemma-2b")
    run_graph_loops(params, cfg, int4=False, model="llava-gemma-2b")
    run_gemma_train(params, kernels)
    torch.cuda.empty_cache()
    q4 = quantize_int4g(params)
    del params
    torch.cuda.empty_cache()
    tokens = run_family_serving(q4, cfg, "llava-gemma-2b int4g, int4 KV",
                                kernels, "flash_fwd_d256",
                                "decode_attn_kv4_d256", "int4",
                                {"w4_gemv": 7 * layers})
    with torch.inference_mode():
        (tok8, _), _, launches = timed_run(lambda: generate_greedy(
            q4, cfg, *make_inputs(cfg), max_new_tokens=SHORT_TOKENS,
            eos_id=-1, kv_quant="int8"))
    expect_launches(launches, {
        "flash_fwd_d256": layers,
        "decode_attn_kv8_d256": layers * SHORT_TOKENS,
        "w4_gemv": 7 * layers * SHORT_TOKENS}, "llava-gemma-2b int8-KV run")
    record(kernels, launches, "decode_attn_kv8_d256")
    if not in_vocab(tok8, cfg):
        raise AssertionError("llava-gemma-2b int8-KV tokens out of range")
    run_family_variants(q4, cfg, "llava-gemma-2b", kernels, "int4")
    family_step_times(q4, cfg, "int4", tokens, "llava-gemma-2b")
    run_graph_loops(q4, cfg, int4=True, model="llava-gemma-2b")
    del q4
    torch.cuda.empty_cache()
    print(f"llava-gemma-2b phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# VILA-1.5-13B at 384 px: SigLIP-so400m/14 at layer -2, mlp_downsample (its
# 27 x 27 grid zero-padded to 28 x 28, 196 image tokens), Llama-13B
# ---------------------------------------------------------------------------

VILA = VILA_13B_384
VILA_NAME = "vila-13b-384"
VILA_TAG = "_vila13b"  # the `kernels` line's rows at VILA-13B's shapes
VILA_TRAIN = dict(  # train/vila.py's published recipe, beside LoRA r=128
    loss_alpha=VILA_13B_RECIPE["loss_alpha"],
    learning_rate=VILA_13B_RECIPE["learning_rate"],
    warmup_ratio=VILA_13B_RECIPE["warmup_ratio"])
VILA_EXTRA = (r"^projector/",)  # --tune-mm-projector: trained whole
VILA_S2_SCALES = (384, 768)
VILA_MULTI_TEXT = 64  # text tokens of a multi-image row
# (K, N) of wq, gate/up and down at 13B (g=128: 40, 40 and 108 groups)
VILA_W4_SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120))
VILA_W4_GATE_UP = VILA_W4_SHAPES[1]  # the shape of the K6 and K7 rows
VILA_GEMM_ROWS = (16, 80)  # 4 beams and draft_k-4 verify; batch 80


def check_vila_flash(gen: torch.Generator) -> list:
    """K1 at VILA-13B's prefill (4 rows of spliced_lens(VILA): 228-243
    tokens, H=KVH=40), and K1, K2 and K3 at its train step's pn rows (4 rows
    of TRAIN_TEXT + 195 tokens, every token live), against their plain
    versions, timed beside their bounds and SDPA: the rows flash_fwd,
    flash_bwd_dq and flash_bwd_dkv + VILA_TAG (K1's at the prefill
    shape)."""
    llm = VILA.llm
    h, kvh = llm.num_heads, llm.kv_heads
    lens = spliced_lens(VILA)
    pre = flash_mode_case(gen, "VILA-13B prefill", len(lens), max(lens), h,
                          kvh, lens, {}, timed=True)
    s = TRAIN_TEXT + VILA.num_image_tokens - 1
    train = flash_mode_case(gen, "VILA-13B pn rows", 2 * TRAIN_B, s, h, kvh,
                            (s,) * (2 * TRAIN_B), {}, timed=True)
    torch.cuda.empty_cache()
    rows = []
    for name, case, part in (("flash_fwd", pre, "fwd"),
                             ("flash_bwd_dq", train, "dq"),
                             ("flash_bwd_dkv", train, "dkv")):
        source, replaces = FLASH_SOURCES[name]
        rows.append({"name": name + VILA_TAG, "route": "cuda",
                     "source": source, "replaces": replaces, **case[part]})
    return rows


def vila_kernel_checks(gen: torch.Generator) -> list:
    """The `kernels` line's rows at VILA-13B's shapes: K1, K2, K3; K4 (bf16
    and int4 prompt KV over 228-243 spliced tokens, H=40, Sg=128) for one
    query a row and in its beam mode; K5's per-beam and shared gen stages
    on the same caches; K6 at a greedy step's 4 rows and K7 at 16 and 80
    (VILA_W4_SHAPES, g=128; the rows at gate/up, 4 and 16 rows)."""
    gemv = check_w4(gen, VILA_W4_SHAPES, (4,), per_channel=False, also=(),
                    row_at=(*VILA_W4_GATE_UP, 4), tag=VILA_TAG,
                    model="VILA-13B")
    gemm = check_w4_gemm(gen, VILA_W4_SHAPES, (), VILA_GEMM_ROWS,
                         per_channel=False, row_at=(*VILA_W4_GATE_UP, 16),
                         tag=VILA_TAG, model="VILA-13B")
    return [*check_vila_flash(gen),
            *decode_rows(gen, VILA.llm, spliced_lens(VILA),
                         (("bf16", 1), ("kv4", 1), ("bf16", BEAMS),
                          ("kv4", BEAMS)), VILA_TAG),
            *fold_rows(gen, VILA.llm, spliced_lens(VILA), FOLD_CASES,
                       VILA_TAG),
            gemv, gemm]


def run_vila_multi_image(params, cfg) -> None:
    """One llava.forward at full width with images (B=2, K=2, 3, 384, 384):
    row 0 holds 2 image sentinels, row 1 one (its second block parked after
    its content): finite logits on the live positions, segment id 0 on the
    whole parked block, each row's live count its text plus its real
    blocks."""
    k, t, s = 2, cfg.num_image_tokens, VILA_MULTI_TEXT
    rng = np.random.RandomState(9)
    ids = rng.randint(5, 30000, (2, s)).astype(np.int32)
    ids[0, [1, 20]] = IMAGE_TOKEN_INDEX
    ids[1, 1] = IMAGE_TOKEN_INDEX
    seg = np.ones((2, s), np.int32)
    seg[1, 50:] = 0
    ids[1, 50:] = 0
    size = cfg.vision.image_size
    images = rng.randn(2, k, 3, size, size).astype(np.float32)
    ids, seg, images = (torch.from_numpy(a).to(DEVICE)
                        for a in (ids, seg, images))
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        (logits, sp), secs, launches = timed_run(lambda: llava.forward(
            params, cfg, ids, images.bfloat16(), seg))
        peak = torch.cuda.max_memory_allocated()
    live = sp.segment_ids != 0
    real1 = 50 + (t - 1)
    ok = (tuple(logits.shape) == (2, s + k * (t - 1), cfg.llm.vocab_size)
          and bool(torch.isfinite(logits[live]).all())
          and int(live[0].sum()) == s + k * (t - 1)
          and int(live[1].sum()) == real1
          and not bool(live[1, real1:real1 + t].any()))
    print(f"{VILA_NAME} multi-image forward (B=2 rows of {s} tokens, K={k} "
          f"image slots, one row with 1 image): logits "
          f"{tuple(logits.shape)}, live positions {live.sum(1).tolist()} "
          f"(row 1's parked block at {real1}-{real1 + t - 1} segment id 0), "
          f"{secs * 1e3:.1f} ms on the host clock, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {launches} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the multi-image forward is wrong")


def tower_line(name: str, fn, want_shape: tuple) -> None:
    """One full-width tower call: its shape, finite, device ms (CUDA events,
    median of 3 after a warm-up) and peak memory, beside the card."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = timed_ms(fn, iters=3, warmup=1)
    ok = tuple(out.shape) == want_shape and bool(torch.isfinite(out).all())
    print(f"{name}: output {tuple(out.shape)} (expected {want_shape}), "
          f"finite {bool(torch.isfinite(out).all())}; {ms:.2f} ms a call "
          f"({gpu_line()}), peak memory {peak / 2**30:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: bad output")
    return out


def run_vila_s2(params, cfg) -> None:
    """S2 on VILA's SigLIP tower at full width: encode_multiscale at
    VILA_S2_SCALES on the 4 requests' images (one tower call over 4 x
    (1 + 4) tiles of 384 px), against the base-scale encode on its first
    channel block."""
    images = make_inputs(cfg)[1].bfloat16()
    v, vc, layer = params["vision"], cfg.vision, cfg.mm_vision_select_layer
    side = vc.image_size // vc.patch_size
    out = tower_line(
        f"S2 on SigLIP-so400m/14-384 at scales {VILA_S2_SCALES} (B=4)",
        lambda: s2.encode_multiscale(v, vc, images, scales=VILA_S2_SCALES,
                                     select_layer=layer),
        (4, side * side, vc.hidden_size * len(VILA_S2_SCALES)))
    with torch.inference_mode():
        base = vit.encode(v, vc, images, select_layer=layer)
    same = torch.equal(out[..., :vc.hidden_size], base)
    print(f"S2: the first channel block equals the base-scale encode "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("S2's base scale differs from vit.encode")


def run_other_towers() -> None:
    """InternViT-6B-448 and RADIO ViT-H/16-432 at full width, each a random
    bf16 tower from seed 0 run on one image: InternViT through vit.encode
    (RMSNorm blocks, q/k norm over the whole width, LayerScale; layer -2),
    RADIO through encode_radio with no unshuffle (its 27 x 27 grid is odd:
    an unshuffle of 2 raises, as PixelUnshuffle does)."""
    rng = np.random.RandomState(10)
    for name, vcfg in (("InternViT-6B-448", INTERNVIT_6B_448),
                       ("RADIO ViT-H/16-432", RADIO_VIT_H_432)):
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = tree.init_vision_params(vcfg, gen, torch.bfloat16, DEVICE)
        torch.cuda.synchronize()
        size = vcfg.image_size
        radio = vcfg is RADIO_VIT_H_432
        pix = rng.rand(1, 3, size, size) if radio else rng.randn(
            1, 3, size, size)
        x = torch.from_numpy(pix.astype(np.float32)).to(DEVICE).bfloat16()
        print(f"tower: {name}, {vcfg.num_layers} layers, width "
              f"{vcfg.hidden_size}, {vcfg.num_heads} heads, "
              f"{vcfg.num_prefix_tokens} prefix tokens; "
              f"{tree_bytes(v) / 1e9:.3f} GB random bf16 in "
              f"{time.perf_counter() - t0:.1f} s")
        side = size // vcfg.patch_size
        if radio:
            tower_line(f"{name} encode_radio", lambda: vit.encode_radio(
                v, vcfg, x), (1, side * side, vcfg.hidden_size))
            try:
                vit.encode_radio(v, vcfg, x, pixel_unshuffle=2)
            except ValueError as e:
                print(f"{name} with pixel_unshuffle=2: ValueError ({e}) ok")
            else:
                raise AssertionError(f"{name}: the odd grid's unshuffle ran")
        else:
            tower_line(f"{name} encode (layer -2)", lambda: vit.encode(
                v, vcfg, x, select_layer=-2), (1, side * side,
                                               vcfg.hidden_size))
        del v
        torch.cuda.empty_cache()


def run_vila(kernels: dict) -> None:
    """VILA-1.5-13B at 384 px at full width and depth from a seeded random
    bf16 tree, then its int4g tree with int4 prompt KV: greedy decode of
    the 4 requests (196 image tokens each; 40 K1 a prefill, 40 K4 a token,
    280 K6 an int4g token) against the plain route within 4/3 of a noise
    floor, 4 beams on the route "auto" takes and a short run on the other,
    draft_k-4 speculative decode (K7 at B*K rows), each graph loop against
    its eager body, each step's device time beside the plain route's; on
    the bf16 tree the multi-image forward, S2 on its tower and the DPA step
    by train/vila.py's recipe (LoRA r=128, the projector trained whole,
    loss alpha 0.2: 200 K1, 80 K2 and 80 K3 a micro-step, one micro-step
    against the plain route within 4/3 of a noise floor in alignment, KL,
    LoRA and projector grads); then InternViT-6B and RADIO-H at full width.
    The counts go to the rows + VILA_TAG."""
    cfg = VILA
    llm = cfg.llm
    layers = llm.num_layers
    side = cfg.vision.image_size // cfg.vision.patch_size
    if cfg.num_image_tokens != 196:
        raise AssertionError(f"{VILA_NAME}: {cfg.num_image_tokens} image "
                             "tokens, not 196")
    print(f"route: {VILA_NAME}'s SigLIP grid {side} x {side} -> "
          f"mlp_downsample pads it to {side + side % 2} x {side + side % 2}"
          f" and folds 2 x 2: {cfg.num_image_tokens} image tokens a request "
          f"(spliced lengths {spliced_lens(cfg)}); attn_impl='auto' at head "
          f"dim {llm.head_size} -> {kernel_route('auto', llm.head_size)} "
          f"(K1-K5, H=KVH={llm.num_heads}); the tower's attention -> "
          "attention_reference (plain, as the reference's)")
    t0 = time.perf_counter()
    peaks = {}

    def mark(what: str):  # the peak since the last mark (or a reset)
        peaks[what] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        clock(f"{VILA_NAME}: {what}")

    params = new_tree(cfg, f"{VILA_NAME} (VILA-1.5-13B: SigLIP-so400m/14-384"
                      " at layer -2, mlp_downsample 4608 -> 5120 -> 5120, "
                      "Llama-13B)")
    what = f"{VILA_NAME} bf16"
    tokens = run_family_serving(params, cfg, what, kernels, "flash_fwd",
                                "decode_attn", tag=VILA_TAG)
    mark("bf16 serving")
    run_family_variants(params, cfg, VILA_NAME, kernels, False, VILA_TAG)
    family_step_times(params, cfg, False, tokens, VILA_NAME)
    mark("bf16 beams, verify, step times")
    run_graph_loops(params, cfg, int4=False, model=VILA_NAME)
    run_vila_multi_image(params, cfg)
    mark("bf16 graph loops, multi-image forward")
    run_vila_s2(params, cfg)
    mark("S2")
    torch.cuda.empty_cache()
    run_train(params, kernels, cfg, what=f"{VILA_NAME} ",
              overrides=VILA_TRAIN, extra=VILA_EXTRA, tag=VILA_TAG)
    mark("training")
    torch.cuda.empty_cache()
    q4 = quantize_int4g(params)
    mark("int4g quantize")
    del params
    torch.cuda.empty_cache()
    what = f"{VILA_NAME} int4g, int4 KV"
    tokens = run_family_serving(q4, cfg, what, kernels, "flash_fwd",
                                "decode_attn_kv4", "int4",
                                {"w4_gemv": 7 * layers}, tag=VILA_TAG)
    mark("int4g serving")
    run_family_variants(q4, cfg, VILA_NAME, kernels, "int4", VILA_TAG)
    family_step_times(q4, cfg, "int4", tokens, VILA_NAME)
    run_graph_loops(q4, cfg, int4=True, model=VILA_NAME)
    mark("int4g beams, verify, graph loops")
    del q4
    torch.cuda.empty_cache()
    run_other_towers()
    mark("InternViT and RADIO")
    top = max(peaks, key=peaks.get)
    print(f"{VILA_NAME} phase: {time.perf_counter() - t0:.1f} s, peak "
          f"memory {peaks[top] / 2**30:.2f} GiB in {top} ({gpu_line()}); "
          "peaks by part (GiB): " + ", ".join(
              f"{k} {v / 2**30:.2f}" for k, v in peaks.items()))


# --------------------------------------------------------------------------
# The device mesh (parallel/): manual TP and data parallelism on two ranks of
# the one card, a world of one over NCCL, and context parallelism.
# --------------------------------------------------------------------------

MESH_TP = 2  # the model axis of the two-rank phase
TP2_TAG = "_tp2"  # the `kernels` line's rows at the tp=2 shard shapes
# the 7B's decode matmuls on one of two ranks: wq/wk/wv and gate/up split by
# columns, wo and down by rows (down: K = 5504 = 86 x 64, 43 groups of 128)
TP2_W4_COLUMNS = ((4096, 2048), (4096, 5504))
TP2_W4_ROWS = ((5504, 4096), (2048, 4096))
TP2_GATE_UP, TP2_DOWN = TP2_W4_COLUMNS[1], TP2_W4_ROWS[0]
TP2_LLM = dataclasses.replace(LLAVA_V15_7B.llm, hidden_size=2048,
                              num_heads=16, num_kv_heads=16)  # local heads
TP2_GEMM_ROWS = 16  # the batch-16 TP run: K7 at each shard's matmuls
CP_TOKENS, CP_SHARDS = 4096, 4  # (c): one row over 4 shards, H=32, D=128
CP2_TOKENS = 2048  # (b): context_parallel_attention over {seq: 2}
MESH_TIMEOUT_S = 600
CP_TAG = "_cp4096"


def cp_row_inputs(gen, s: int, h: int = 32):
    """One row of s tokens: q, k, v and a cotangent, bf16 (H=KVH=h, D=128),
    leaves with grad; every token live."""
    def r():
        return torch.randn(1, s, h, 128, generator=gen,
                           device=DEVICE).bfloat16()

    q, k, v, w = r(), r(), r(), r()
    seg = torch.ones(1, s, dtype=torch.int32, device=DEVICE)
    return [t.requires_grad_() for t in (q, k, v)], w, seg


def cp_against_full(got, want) -> tuple:
    """(ok, text): out and grads against the full call's, by the smoke's
    shard-against-full-call rule (flash_mode_case): |d| <= KERNEL_ATOL *
    scale + BWD_RTOL * |full|, scale 1 for the output and max|full| for a
    grad (dK, dV: bf16 sums of the shards' grads)."""
    ok, line = True, []
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        scale = 1.0 if name == "o" else float(w.abs().max())
        good = bool((g - w).abs().le(KERNEL_ATOL * scale
                                     + BWD_RTOL * w.abs()).all()
                    and torch.isfinite(g).all())
        ok = ok and good
        line.append(f"{name} {max_abs(g, w):.3e} rel {rel_err(g, w):.3e}")
    return ok, ", ".join(line)


def mesh_kernel_checks(gen: torch.Generator) -> list:
    """The `kernels` line's rows of the mesh paths: K6 at a tp=2 shard's
    decode matmuls (4 rows: gate/up N=5504 and, a row of its own, down
    K=5504), K7 at 16 rows, K4 at 16 local heads over int4 prompt caches;
    K1, K2 and K3 on the last of 4 context-parallel shards of a 4,096-token
    row (q_offset 3,072 against all keys), timed, against their plain
    versions and the full call's rows."""
    model = "LLaVA-1.5-7B tp=2 shard"
    gemv = check_w4(gen, TP2_W4_COLUMNS, (4,), per_channel=False, also=(),
                    row_at=(*TP2_GATE_UP, 4), tag=TP2_TAG, model=model)
    down = check_w4(gen, TP2_W4_ROWS, (4,), per_channel=False, also=(),
                    row_at=(*TP2_DOWN, 4), tag=TP2_TAG + "_down", model=model)
    gemm = check_w4_gemm(gen, TP2_W4_COLUMNS + TP2_W4_ROWS, (),
                         (TP2_GEMM_ROWS,), per_channel=False,
                         row_at=(*TP2_GATE_UP, TP2_GEMM_ROWS), tag=TP2_TAG,
                         model=model)
    n = CP_TOKENS // CP_SHARDS
    cp = flash_mode_case(gen, f"context-parallel shard {CP_SHARDS} of "
                         f"{CP_SHARDS}", 1, CP_TOKENS, 32, 32, (CP_TOKENS,),
                         {}, shard=(CP_TOKENS - n, n), timed=True)
    rows = []
    for part, kernel in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"),
                         ("dkv", "flash_bwd_dkv")):
        source, replaces = FLASH_SOURCES[kernel]
        rows.append({"name": kernel + CP_TAG, "route": "cuda",
                     "source": source, "replaces": replaces, **cp[part]})
    torch.cuda.empty_cache()
    return [gemv, down, gemm,
            *decode_rows(gen, TP2_LLM, PROMPT_LENS, (("kv4", 1),), TP2_TAG),
            *rows]


class SmokeTok:
    """A word-level tokenizer (the card's machine has no transformers): the
    runner's interface, a BOS, ids from the words' characters."""

    bos_token_id, eos_token_id = 1, 2

    def __call__(self, text):
        ids = [1] + [5 + sum(map(ord, w)) % 30000 for w in text.split()]
        return SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids if i > 4)


def run_world_of_one(q4, cfg, tokens) -> None:
    """(a): a world of one over NCCL, mesh {1, 1}: generate(mesh=) and
    BatchedGenerator(mesh=) give the meshless tokens and texts exactly,
    the decode loop captured."""
    inputs = make_inputs(cfg)
    mesh = make_mesh(data=1, model=1, device=DEVICE)
    backend = dist.get_backend(mesh.group("model"))
    stats = {}
    with torch.inference_mode():
        (got, num), secs, launches = timed_run(lambda: generate(
            q4, cfg, *inputs, NEW_TOKENS, -1, kv_quant="int4", mesh=mesh,
            loop_stats=stats))
    layers = cfg.llm.num_layers
    expect_launches(launches, {
        "flash_fwd": layers, "decode_attn_kv4": layers * NEW_TOKENS,
        "w4_gemv": 7 * layers * NEW_TOKENS}, "{1, 1} mesh run")
    reqs = [runner_mod.EvalRequest(question_id=i, image_path=None,
                                   text=f"Describe item {i} in detail."
                                   + " Please." * i) for i in range(6)]
    kw = dict(batch_size=4, max_new_tokens=SHORT_TOKENS, prompt_bucket=64,
              kv_quant="int4")
    proc = SimpleNamespace(crop_size=cfg.vision.image_size)
    texts = runner_mod.BatchedGenerator(q4, cfg, SmokeTok(), proc,
                                        **kw).run(reqs)
    mtexts = runner_mod.BatchedGenerator(q4, cfg, SmokeTok(), proc,
                                         mesh=mesh, **kw).run(reqs)
    ok = (torch.equal(got, tokens) and bool((num == NEW_TOKENS).all())
          and stats["graph"] and texts == mtexts
          and backend == ("gloo" if mesh.device.type == "cpu" else "nccl"))
    print(f"mesh (a): a world of one over {backend}, mesh {mesh.shape}: "
          f"generate(mesh=) {tuple(got.shape)} tokens equal to the meshless "
          f"int4g main run's {torch.equal(got, tokens)}, loop captured "
          f"{stats['graph']} ({stats['steps']} steps, {secs:.3f} s); "
          f"BatchedGenerator(mesh=) texts of {len(reqs)} requests equal to "
          f"the meshless ones {texts == mtexts} {'ok' if ok else 'FAIL'}")
    dist.destroy_process_group()
    if not ok:
        raise AssertionError("the {1, 1} mesh run differs from the meshless")


# ---- the training half of the mesh ------------------------------------------

MESH_ONE_STEPS = 2  # (a): the train phase's first micro-steps, on {1, 1}
# (b): a constant lr large enough that one AdamW update moves bf16 LoRA
# leaves (the recipe's warmup makes the first update lr(0) = 0)
MESH_TRAIN_LR = 1e-3
# (b)'s runs: name, (data, model), batch kind
MESH_TRAIN_RUNS = (("fsdp", (MESH_TP, 1), "rows"), ("tp", (1, MESH_TP), "rows"),
                   ("packed", (MESH_TP, 1), "packed"))
# (b)'s depth, at full width: gloo carries every gathered layer through host
# memory, 5 gathers of each layer a micro-step (3 forwards, 2 remat
# recomputes), ~200 MB each; on an H100 a micro-step of 8 layers took
# 15-19 s of the phase's time
MESH_TRAIN_LAYERS = 2
MESH_TRAIN_PARTS = ("loss", "alignment", "kl", "LoRA update")


def run_train_world_of_one(params, keep: dict) -> None:
    """(a) of the mesh-train phase: a world of one over NCCL, mesh {1, 1}.
    MESH_ONE_STEPS micro-steps of run_train's recipe on the bf16 7B tree at
    full width and depth through init_train_state(mesh=) and
    dpa_step_fns(mesh=) must equal run_train's first micro-steps (`keep`)
    bit for bit: metrics, and the LoRA leaves, AdamW moments and
    accumulators after them."""
    cfg = CFG
    layers = cfg.llm.num_layers
    mesh = make_mesh(data=1, model=1, device=DEVICE)
    backend = dist.get_backend(mesh.group("model"))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    policy = add_lora(params, gen, rank=128, alpha=256.0)
    tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400, remat=True,
                       loss_chunk=256)
    trainable, frozen, opt, opt_state = init_train_state(policy, tcfg,
                                                         mesh=mesh)
    step, _ = dpa_step_fns(cfg, tcfg, opt, mesh=mesh)
    metrics = []
    t0 = time.perf_counter()
    for i in range(MESH_ONE_STEPS):
        batch = train_batch(cfg, i)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        trainable, opt_state, m = step(trainable, frozen, None, opt_state,
                                       batch)
        torch.cuda.synchronize()
        expect_launches(dict(_kernels.launches), {
            "flash_fwd": 5 * layers, "flash_bwd_dq": 2 * layers,
            "flash_bwd_dkv": 2 * layers}, f"{{1, 1}} mesh train micro-step {i}")
        metrics.append([float(x) for x in m])
    secs = time.perf_counter() - t0
    same_metrics = metrics == keep["metrics"]
    same_state = train_state_sums(trainable, opt) == keep["sums"]
    ok = (same_metrics and same_state
          and backend == ("gloo" if mesh.device.type == "cpu" else "nccl"))
    print(f"mesh-train (a): a world of one over {backend}, mesh {mesh.shape}:"
          f" {MESH_ONE_STEPS} micro-steps of {cfg.llm.num_layers} layers "
          "through init_train_state(mesh=) and dpa_step_fns(mesh=), "
          f"{secs:.2f} s; metrics equal to the meshless train phase's bit "
          f"for bit {same_metrics} (loss {metrics[-1][0]:.6f}, grad_norm "
          f"{metrics[-1][3]:.4e}); LoRA leaves, AdamW moments and "
          f"accumulators after them equal bit for bit {same_state} "
          f"({gpu_line()}) {'ok' if ok else 'FAIL'}")
    del policy, trainable, frozen, opt, opt_state, step
    dist.destroy_process_group()
    if not ok:
        raise AssertionError("the {1, 1} mesh train step differs from the "
                             "meshless one")


def mesh_train_inputs(params) -> dict:
    """(b)'s inputs: the first MESH_TRAIN_LAYERS layers of the bf16 tree at
    full width (the layer stacks copied: the whole tree is freed before the
    mesh phase), their config, train_batch's unpacked batch and the first packed
    batch of PackSamples in 2 pn and 2 ref rows of PACK_SEQ tokens, which
    must hold a sample whose positive and negative documents lie in
    different rows (so on different data ranks)."""
    cut, cfg8 = depth_cut(params, CFG, MESH_TRAIN_LAYERS)
    cut["llm"]["layers"] = tree.map_tree(lambda t: t.clone(),
                                         cut["llm"]["layers"])
    batcher = PackedDPABatcher(
        seq_len=PACK_SEQ, pn_rows=MESH_TP, ref_rows=MESH_TP,
        max_samples=PACK_BATCH, num_image_tokens=cfg8.num_image_tokens,
        pad_token_id=0,
        image_shape=(3, cfg8.vision.image_size, cfg8.vision.image_size))
    packed = next(batcher.batches(iter(PackSamples(cfg8, n=8).items)))
    sid, neg = packed["pn_sample_ids"], packed["pn_neg_flags"]
    straddle = [s for s in range(1, int(packed["n_samples"]) + 1)
                if set(np.nonzero((sid == s) & (neg == 0))[0])
                != set(np.nonzero((sid == s) & (neg == 1))[0])]
    if not straddle:
        raise AssertionError("the mesh-train packed batch has no sample "
                             "across the data ranks")
    return {"tree": cut, "cfg": cfg8, "rows": train_batch(cfg8, 0),
            "packed": on_card(packed), "straddle": straddle,
            "n_samples": int(packed["n_samples"])}


def mesh_train_step(inputs: dict, kind: str, mesh=None, noise=None) -> dict:
    """One micro-step of (b) on `inputs`' tree and `kind` batch: on this
    rank's shards and rows (`mesh`) or on one device, where `noise`
    perturbs the text-embedding table (a noise-floor draw). The policy is
    comparison_policy's (lora_b small and nonzero), lr MESH_TRAIN_LR
    constant. Returns the metrics, the whole LoRA leaves' update (fp32,
    flat), this process's K1-K3 launches and peak memory, and the host
    seconds of the step and of the set-up and read-back around it."""
    t_set = time.perf_counter()
    cfg8 = inputs["cfg"]
    policy = comparison_policy(inputs["tree"])
    tcfg = TrainConfig(learning_rate=MESH_TRAIN_LR, lr_schedule="constant",
                       grad_accum_steps=1, num_train_steps=400, remat=True,
                       loss_chunk=256)
    trainable, frozen, opt, opt_state = init_train_state(policy, tcfg,
                                                         mesh=mesh)
    if noise is not None:
        frozen = tree.map_tree(lambda x: x, frozen)
        frozen["llm"]["embed"]["embedding"] = perturbed(
            frozen["llm"]["embed"]["embedding"], noise)
    whole = (lambda t: t) if mesh is None else opt.layout.whole

    def flat(t):
        return torch.cat([x.detach().float().flatten()
                          for _, x in tree.flatten(whole(t))
                          if x is not None])

    before = flat(trainable)
    batch = inputs[kind]
    if kind == "packed":
        step, _ = packed_dpa_step_fns(cfg8, tcfg, opt, max_samples=PACK_BATCH,
                                      mesh=mesh)
    else:
        step, _ = dpa_step_fns(cfg8, tcfg, opt, mesh=mesh)
    if mesh is not None:
        partition.check_train_rows(batch, mesh, kind == "packed")
        batch = (partition.shard_packed_batch(batch, mesh) if kind == "packed"
                 else partition.shard_batch(batch, mesh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    trainable, opt_state, m = step(trainable, frozen, None, opt_state, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = {"parts": [float(x) for x in m], "launches": dict(_kernels.launches),
           "peak": torch.cuda.max_memory_allocated(), "s": t1 - t0}
    out["delta"] = flat(trainable) - before
    torch.cuda.synchronize()
    out["other_s"] = (t0 - t_set) + (time.perf_counter() - t1)
    return out


def train_errs(got: dict, want: dict) -> tuple:
    """Relative errors of the loss, alignment and KL, and of the LoRA
    update as a whole vector."""
    return tuple(abs(g - w) / abs(w) for g, w in zip(got["parts"][:3],
                                                      want["parts"][:3])) + (
        rel_err(got["delta"], want["delta"]),)


def mesh_train_refs(inputs: dict) -> dict:
    """The one-device step of each (b) batch kind, and its noise floor: the
    largest of FLOOR_DRAWS perturbations of the text-embedding table by
    2^-7 N(0, 1) relative, per quantity (compare_train's floor)."""
    noise = torch.Generator(device=DEVICE).manual_seed(3)
    refs = {}
    for kind in ("rows", "packed"):
        want = mesh_train_step(inputs, kind)
        draws = [train_errs(mesh_train_step(inputs, kind, noise=noise), want)
                 for _ in range(FLOOR_DRAWS)]
        refs[kind] = dict(want, floor=tuple(max(x) for x in zip(*draws)),
                          draws=draws)
    torch.cuda.empty_cache()
    return refs


def mesh_rank_train(inputs: dict, meshes: dict) -> dict:
    """(b)'s train runs on this rank: errors against the one-device steps
    (`inputs["want"]`, shared by CUDA IPC), launches, peak memory."""
    out = {}
    for name, _, kind in MESH_TRAIN_RUNS:
        got = mesh_train_step(inputs, kind, meshes[name])
        out[name] = {"parts": got["parts"], "launches": got["launches"],
                     "peak": got["peak"], "s": got["s"],
                     "other_s": got["other_s"],
                     "errs": train_errs(got, inputs["want"][kind])}
        del got
        torch.cuda.empty_cache()
    return out


def check_mesh_train(results: dict, inputs: dict) -> None:
    """(b)'s train runs from both ranks against their one-device steps
    within TRAIN_FLOOR_FACTOR of the floor, K1-K3 launched on every rank."""
    layers = inputs["cfg"].llm.num_layers
    want_launches = {"flash_fwd": 5 * layers, "flash_bwd_dq": 2 * layers,
                     "flash_bwd_dkv": 2 * layers}
    for kind in ("rows", "packed"):
        ref = inputs["want"][kind]
        print(f"mesh-train (b) one-device {kind} step (reduced: the first "
              f"{layers} of {CFG.llm.num_layers} layers, at full width): loss {ref['parts'][0]:.6f} alignment "
              f"{ref['parts'][1]:.6f} kl {ref['parts'][2]:.4e}, "
              f"{ref['s']:.2f} s, peak {ref['peak'] / 2**30:.2f} GiB; noise "
              f"floor (largest of {FLOOR_DRAWS} draws) " + ", ".join(
                  f"{n} {f:.3e}" for n, f in zip(MESH_TRAIN_PARTS,
                                                  ref["floor"])))
    bad = []
    for name, shape, kind in MESH_TRAIN_RUNS:
        floor = inputs["want"][kind]["floor"]
        for r, out in sorted(results.items()):
            got = out["train"][name]
            expect_launches(got["launches"], want_launches,
                            f"rank {r}'s mesh-train {name} step")
            ok = (all(np.isfinite(got["parts"]))
                  and all(e <= TRAIN_FLOOR_FACTOR * f
                          for e, f in zip(got["errs"], floor)))
            if not ok:
                bad.append(f"{name} rank {r}")
            launches = {k: got["launches"].get(k, 0) for k in want_launches}
            print(f"mesh-train (b) {name} {{data {shape[0]}, model "
                  f"{shape[1]}}} ({kind}"
                  + (f", samples {inputs['straddle']} of "
                     f"{inputs['n_samples']} across the data ranks"
                     if kind == "packed" else "")
                  + f") rank {r}: loss {got['parts'][0]:.6f}, grad_norm "
                  f"{got['parts'][3]:.4e}; rel err against one device "
                  + ", ".join(f"{n} {e:.3e}" for n, e in
                              zip(MESH_TRAIN_PARTS, got["errs"]))
                  + f" (bound {TRAIN_FLOOR_FACTOR:.3f} x floor); launches "
                  f"{launches}; peak {got['peak'] / 2**30:.2f} GiB; the "
                  f"step {got['s']:.2f} s, set-up and read-back "
                  f"{got['other_s']:.2f} s ({gpu_line()}) "
                  f"{'ok' if ok else 'FAIL'}")
    if bad:
        raise AssertionError(f"mesh-train runs disagree with one device: "
                             f"{bad}")


def mesh_rank(rank: int, port: int, inbox, outbox) -> None:
    """One of the two ranks of (b) on the one card: gloo over CUDA tensors.
    Runs manual TP on its shards ({data 1, model 2}), data parallelism over
    the whole int4g tree ({data 2, model 1}) and context_parallel_attention
    over {seq 2}; prints its launches; returns its results on `outbox`."""
    try:
        torch.cuda.set_device(0)
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=MESH_TP, timeout=datetime.timedelta(
                seconds=MESH_TIMEOUT_S))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the first optimizer a process builds imports this (seconds on the
        # card's host): load it while the main process makes the references
        importlib.import_module("torch._dynamo")
        got = inbox.get(timeout=MESH_TIMEOUT_S)
        outbox.put((rank, "ok", mesh_rank_work(rank, got)))
    except BaseException:
        import traceback

        outbox.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_rank_work(rank: int, got: dict) -> dict:
    """mesh_rank's runs; tensors come back as numpy (a tensor in a queue
    lives in this process, which ends first)."""
    t_start = time.perf_counter()
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    inputs = got["inputs"]
    out = {}
    tp = make_mesh(data=1, model=MESH_TP, device=DEVICE)
    placed = partition.Placed(got["shard"], "manual_tp")
    group = tp.group("model")
    with torch.inference_mode():
        generate(placed, cfg, *inputs, 2, -1, kv_quant="int4",
                 mesh=tp)  # warm-up, not counted
        out["tp_logits"] = _prefill_impl(
            got["shard"], cfg, *inputs, kv_quant="int4", tp=MESH_TP,
            tp_group=group)[1].cpu().numpy()
        stats = {}
        (tok, num), secs, out["tp_launches"] = timed_run(lambda: generate(
            placed, cfg, *inputs, NEW_TOKENS, -1, kv_quant="int4", mesh=tp,
            loop_stats=stats))
        out.update(tp_tokens=tok.cpu().numpy(), tp_num=num.cpu().numpy(),
                   tp_s=secs, tp_graph=stats["graph"])
        rows16 = [t.repeat(TP2_GEMM_ROWS // t.shape[0], *[1] * (t.ndim - 1))
                  for t in inputs]
        (tok16, _), _, out["tp16_launches"] = timed_run(lambda: generate(
            placed, cfg, *rows16, SHORT_TOKENS, -1, kv_quant="int4",
            mesh=tp))
        out["tp16_ok"] = in_vocab(tok16, cfg)
        dp = make_mesh(data=MESH_TP, model=1, device=DEVICE)
        stats = {}
        generate(got["q4"], cfg, *inputs, 2, -1, kv_quant="int4", mesh=dp)
        (tok, _), secs, out["dp_launches"] = timed_run(lambda: generate(
            got["q4"], cfg, *inputs, NEW_TOKENS, -1, kv_quant="int4",
            mesh=dp, loop_stats=stats))
        out.update(dp_tokens=tok.cpu().numpy(), dp_s=secs,
                   dp_graph=stats["graph"])
    # context_parallel_attention over {seq: 2}; every rank draws the same
    # row from one seed and holds the result against the full call
    cp = axes_mesh({"seq": MESH_TP}, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    (q, k, v), w, seg = cp_row_inputs(gen, CP2_TOKENS)
    _kernels.reset_launches()
    o = context_parallel_attention(cp, q, k, v, seg, seg)
    (o.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    out["cp_launches"] = dict(_kernels.launches)
    got_cp = [o.detach(), q.grad, k.grad, v.grad]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o2 = flash_attention(q2, k2, v2, seg, seg)
    (o2.float() * w.float()).sum().backward()
    out["cp_ok"], out["cp_line"] = cp_against_full(
        got_cp, [o2.detach(), q2.grad, k2.grad, v2.grad])
    t_train = time.perf_counter()
    out["train"] = mesh_rank_train(got["train"], {"fsdp": dp, "tp": tp,
                                                  "packed": dp})
    out["serve_s"] = t_train - t_start
    out["train_s"] = time.perf_counter() - t_train
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "halva_tpu"))
    print(f"mesh rank {rank}: launches, manual TP {{data 1, model 2}} "
          f"{out['tp_launches']}; its batch-{TP2_GEMM_ROWS} run "
          f"{out['tp16_launches']}; data parallelism {{data 2, model 1}} "
          f"{out['dp_launches']}; context parallelism {{seq 2}} "
          f"{out['cp_launches']}; serving and CP runs {out['serve_s']:.1f} s, "
          f"train runs {out['train_s']:.1f} s", flush=True)
    return out


def run_two_ranks(q4, shards, tokens, kernels, train: dict) -> None:
    """(b): two ranks on the one card (spawned, gloo over CUDA tensors; the
    weights are this process's, shared by CUDA IPC): manual TP on the
    tp=2-packed int4g tree's shards against the single-device int4g prefill
    logits and greedy tokens, data parallelism over the int4g tree token
    for token against the one-device program on each rank's rows, and
    context_parallel_attention over {seq 2} against the full call; then
    the mesh-train runs on `train` (mesh_train_inputs) against their
    one-device steps. The references are computed here while the ranks
    start."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    inputs = make_inputs(cfg)
    half = inputs[0].shape[0] // MESH_TP
    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(MESH_TP)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_rank, args=(r, port, inboxes[r], outbox))
             for r in range(MESH_TP)]
    results, errors = {}, []
    try:
        for p in procs:
            p.start()
        t1 = time.perf_counter()
        train = dict(train, want=mesh_train_refs(train))
        refs_s = time.perf_counter() - t1
        with torch.inference_mode():
            want_logits = _prefill_impl(q4, cfg, *inputs, kv_quant="int4")[1]
            want_rows = [generate(q4, cfg, *(t[r * half:(r + 1) * half]
                                             for t in inputs),
                                  NEW_TOKENS, -1, kv_quant="int4")[0]
                         for r in range(MESH_TP)]
        for r in range(MESH_TP):
            inboxes[r].put({"shard": shards[r], "q4": q4, "inputs": inputs,
                            "train": train})
        for _ in procs:
            rank, status, out = outbox.get(timeout=MESH_TIMEOUT_S)
            if status != "ok":
                errors.append(f"rank {rank}:\n{out}")
                break
            results[rank] = out
    except queue_lib.Empty:
        errors.append(f"no result within {MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    if errors:
        raise AssertionError("the two-rank mesh phase failed: "
                             + "\n".join(errors))
    wall = time.perf_counter() - t0
    for out in results.values():
        for key in ("tp_logits", "tp_tokens", "tp_num", "dp_tokens"):
            out[key] = torch.from_numpy(out[key])
    want_main = {"flash_fwd": layers, "decode_attn_kv4": layers * NEW_TOKENS,
                 "w4_gemv": 7 * layers * NEW_TOKENS}
    want16 = {"flash_fwd": layers, "decode_attn_kv4": layers * SHORT_TOKENS,
              "w4_gemm": 7 * layers * SHORT_TOKENS}
    want_cp = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for r, out in sorted(results.items()):
        expect_launches(out["tp_launches"], want_main, f"rank {r}'s TP run")
        expect_launches(out["tp16_launches"], want16,
                        f"rank {r}'s batch-{TP2_GEMM_ROWS} TP run")
        expect_launches(out["dp_launches"], want_main, f"rank {r}'s DP run")
        expect_launches(out["cp_launches"], want_cp, f"rank {r}'s CP run")
        if out["modules"]:
            raise AssertionError(f"rank {r} imported {out['modules']}")
    r0, r1 = results[0], results[1]
    tp_rel = rel_err(r0["tp_logits"], want_logits.cpu())
    tok_tp = r0["tp_tokens"]
    same = tok_tp == tokens.cpu()
    prefix = same.int().cumprod(dim=1).sum(dim=1).tolist()
    ok = (tp_rel <= LOGITS_REL_W4 and in_vocab(tok_tp, cfg)
          and bool((r0["tp_num"] == NEW_TOKENS).all())
          and torch.equal(tok_tp, r1["tp_tokens"])
          and torch.equal(r0["tp_logits"], r1["tp_logits"])
          and r0["tp16_ok"] and not r0["tp_graph"])
    print(f"mesh (b) manual TP {{data 1, model {MESH_TP}}} (tp=2-packed "
          f"int4g, int4 prompt KV, {TP2_LLM.num_heads} local heads, "
          "all-reduce of wo and down over gloo): prefill logits against the "
          f"single-device int4g logits rel err {tp_rel:.3e} (limit "
          f"{LOGITS_REL_W4}); greedy tokens agree with the int4g main run's "
          f"{float(same.float().mean()):.3f} over {NEW_TOKENS} tokens, equal "
          f"prefixes {prefix}; both ranks' tokens and logits equal; loop "
          f"eager under gloo {not r0['tp_graph']}; {r0['tp_s']:.3f} s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("manual TP disagrees with one device")
    dp_tokens = r0["dp_tokens"]
    rows_ok = all(torch.equal(dp_tokens[r * half:(r + 1) * half],
                              want_rows[r].cpu()) for r in range(MESH_TP))
    ok = (rows_ok and torch.equal(dp_tokens, r1["dp_tokens"])
          and r0["dp_graph"] and r1["dp_graph"])
    agree = float((dp_tokens == tokens.cpu()).float().mean())
    print(f"mesh (b) data parallelism {{data {MESH_TP}, model 1}} over the "
          "int4g tree shared by CUDA IPC: each rank's rows equal the "
          f"one-device program's on them, token for token, {rows_ok}; "
          f"agreement with the batch-4 main run {agree:.3f}; loops captured "
          f"{r0['dp_graph'] and r1['dp_graph']}; {r0['dp_s']:.3f} s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("data parallelism differs from one device")
    ok = r0["cp_ok"] and r1["cp_ok"]
    print(f"mesh (b) context_parallel_attention over {{seq {MESH_TP}}}, one "
          f"row of {CP2_TOKENS} tokens, H=32, D=128, K/V all-gathered and "
          "dK/dV reduce-scattered over gloo: against the full call, rank 0 "
          f"{r0['cp_line']}; rank 1 {r1['cp_line']} (limits o {KERNEL_ATOL} "
          f"+ {BWD_RTOL}*|full|, grads {KERNEL_ATOL}*max|full| + "
          f"{BWD_RTOL}*|full|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("context parallelism disagrees with the full "
                             "call")
    check_mesh_train(results, train)
    print(f"mesh (b): gloo took all_reduce, all_gather_into_tensor and "
          "reduce_scatter_tensor on CUDA tensors, none through host tensors; "
          f"the ranks imported neither jax nor the JAX package; {wall:.1f} s "
          f"with their start, {refs_s:.1f} s of it one-device train "
          "references and floors made while they started")
    # rank 0's counts (asserted above) into the rows at the shard shapes;
    # K6's count is the shard's every matmul, gate/up and down among them
    for row, run, name in (
            ("w4_gemv" + TP2_TAG, "tp_launches", "w4_gemv"),
            ("w4_gemv" + TP2_TAG + "_down", "tp_launches", "w4_gemv"),
            ("w4_gemm" + TP2_TAG, "tp16_launches", "w4_gemm"),
            ("decode_attn_kv4" + TP2_TAG, "tp_launches", "decode_attn_kv4")):
        kernels[row]["launches"] = r0[run].get(name, 0)


def run_cp_long(kernels) -> None:
    """(c): one row of 4,096 tokens, H=32, D=128, over 4 context-parallel
    shards in one process: the 4 shard bodies one after another over the
    whole K/V with their q_offsets (K1 each), their backward (K2, K3 each),
    dK/dV summed over the shards by autograd; against the full call."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    (q, k, v), w, seg = cp_row_inputs(gen, CP_TOKENS)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    o = sequential_cp_attention(q, k, v, seg, seg, CP_SHARDS)
    (o.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    expect_launches(launches, {"flash_fwd": CP_SHARDS,
                               "flash_bwd_dq": CP_SHARDS,
                               "flash_bwd_dkv": CP_SHARDS},
                    f"{CP_SHARDS} context-parallel shard bodies")
    got = [o.detach(), q.grad, k.grad, v.grad]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o2 = flash_attention(q2, k2, v2, seg, seg)
    (o2.float() * w.float()).sum().backward()
    ok, line = cp_against_full(got, [o2.detach(), q2.grad, k2.grad, v2.grad])
    print(f"mesh (c) context parallelism in one process: {CP_SHARDS} shards "
          f"of a {CP_TOKENS}-token row (H=32, D=128), q_offsets "
          f"{[i * CP_TOKENS // CP_SHARDS for i in range(CP_SHARDS)]}, "
          f"forward and backward {secs * 1e3:.1f} ms (host clock); against "
          f"the full call {line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the context-parallel shards disagree with the "
                             "full call")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        kernels[name + CP_TAG]["launches"] = launches.get(name, 0)


def tp2_shards(params) -> list:
    """Each rank's contiguous manual-TP shards of the tp=2-packed int4g
    tree, quantized on the card from the bf16 tree."""
    with torch.no_grad():
        q4tp = quantize_params_int4(params, group_size=W4_GROUP, tp=MESH_TP)
        shards = [partition.eval_shmap_shard_params(
            q4tp, mesh_shape({"data": 1, "model": MESH_TP}, r, DEVICE))
            for r in range(MESH_TP)]
    torch.cuda.synchronize()
    print(f"tp=2-packed int4g tree (g={W4_GROUP}): {tree_bytes(q4tp) / 1e9:.3f}"
          f" GB; each rank's shards {tree_bytes(shards[0]) / 1e9:.3f} GB "
          "(the layer stacks halved, the rest replicated)")
    return shards


def run_mesh(q4, shards, tokens, kernels, train: dict) -> None:
    """The mesh phase: (a), (b) with the mesh-train runs on `train`, and
    (c) above."""
    t0 = time.perf_counter()
    run_world_of_one(q4, LLAVA_V15_7B, tokens)
    torch.cuda.empty_cache()
    clock("mesh: (a) a world of one")
    run_two_ranks(q4, shards, tokens, kernels, train)
    torch.cuda.empty_cache()
    clock("mesh: (b) two ranks")
    run_cp_long(kernels)
    torch.cuda.empty_cache()
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")


# ---- the scripts tail: the chat at batch 1 (halva_tpu_torch/chat.py), the
# eval suite's device half (evals/runner.py) and the converter
# (halva_tpu_torch/convert_checkpoint.py, in run_loader)

B1_TAG = "_b1"  # the `kernels` line's rows at the chat's batch of 1
CHAT_TOKENS = 512  # scripts/chat.py's --max-new-tokens default
CHAT_BEAM_TOKENS = 128
CHAT_INT8_TOKENS = 128
# the int8 chat's W8A8 answer (the CLI's default route, its steps ~6x the
# weight-only route's at B=4): a shorter budget for the smoke's time limit
CHAT_W8A8_TOKENS = 32
CHAT_QUESTIONS = ("What is unusual about this image?",
                  "Is there a cat in the image? Answer in detail.")
CHAT_LEN = max(PROMPT_LENS)  # the rows' spliced prompt: 48 text tokens
CHAT_SLOTS = (8, CHAT_TOKENS - 32)  # gen slots at which a step is timed
CHAT_TTFT_RUNS = 3  # prefills behind the time to the first token
SUITE_BATCH = BATCH80  # the README's eval command: int4g, int4 KV, batch 80
SUITE_CAPTION_TOKENS = 128  # the bench's budget
# a yes/no answer: "Yes" or "No", EOS and one spare (an assumption: random
# weights emit no EOS, so every row runs to this budget)
SUITE_YESNO_TOKENS = 4
SUITE_TEXT_ONLY = 20  # HallusionBench rows with visual_input 0, of 80
POPE_OBJECTS = ("dog", "car", "chair", "person", "bottle", "cup", "bird",
                "umbrella")
# the suite's benchmarks at their public sizes: (name, questions, the batch
# shape that stands for them, source of the count)
SUITE_COUNTS = (
    ("POPE", 27000, "yes/no", "Li et al. 2023, POPE: 3 splits x 3,000 "
     "questions on each of COCO, A-OKVQA and GQA"),
    ("AMBER discriminative", 14216, "yes/no", "Wang et al. 2023, AMBER"),
    ("MME hallucination subset", 240, "yes/no", "Fu et al. 2023, MME: "
     "existence, count, position, color"),
    ("HallusionBench", 1129, "mixed", "Guan et al. 2024, HallusionBench"),
    ("CHAIR", 500, "caption", "Rohrbach et al. 2018; the 500 COCO images "
     "of evals/data"),
    ("AMBER generative", 1004, "caption", "Wang et al. 2023, AMBER"),
    ("MMHal-Bench", 96, "caption", "Sun et al. 2023, LLaVA-RLHF"),
)


def chat_pixels(cfg) -> np.ndarray:
    """A seeded processed image, (1, 3, S, S): the card's machine has no
    Pillow to decode one."""
    size = cfg.vision.image_size
    return np.random.RandomState(5).randn(1, 3, size, size).astype(
        np.float32)


def check_flash_b1(gen: torch.Generator) -> dict:
    """K1 against flash_attention_plain (o and LSE) at the chat's prefill:
    one row of CHAT_LEN tokens, H=KVH=32, causal; timed over distinct
    layers' inputs (one layer's 15 MB would be read from the L2) beside its
    bound and SDPA with the causal mask."""
    b, s, h, d = 1, CHAT_LEN, 32, 128
    layers = walk_layers(3 * s * h * d * 2)

    def r():
        return torch.randn(layers, b, s, h, d, generator=gen,
                           device="cuda").bfloat16()

    q, k, v = r(), r(), r()
    seg = lengths_to_seg((s,), s, "cuda")
    tag = f"B={b} S={s} H={h} KVH={h} D={d} causal"
    err = 0.0
    for li in (0, layers - 1):
        o, lse = flash_attention_fwd(q[li], k[li], v[li], seg, seg)
        want = flash_attention_plain(q[li], k[li], v[li], seg, seg)
        err = max(err, held(f"flash_fwd{B1_TAG} {tag} layer {li}", o, want))
    logits = torch.einsum("bqhd,bkhd->bhqk", q[li].float(),
                          k[li].float()) * d**-0.5
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    want_lse = logits.masked_fill(~mask, -1e30).logsumexp(-1)
    del logits
    lse_err = max_abs(lse, want_lse)
    print(f"flash_fwd{B1_TAG} {tag}: lse_err {lse_err:.3e} (limit "
          f"{LSE_MAX_ABS}) {'ok' if lse_err <= LSE_MAX_ABS else 'FAIL'}")
    if lse_err > LSE_MAX_ABS:
        raise AssertionError(f"flash_fwd{B1_TAG}: LSE disagrees with the "
                             "plain log-sum-exp")
    ms = device_ms(lambda: [flash_attention_fwd(q[i], k[i], v[i], seg, seg)
                            for i in range(layers)]) / layers
    plain_ms = device_ms(lambda: [flash_attention_plain(q[i], k[i], v[i],
                                                        seg, seg)
                                  for i in range(layers)]) / layers
    qt, kt, vt = (t.transpose(2, 3) for t in (q, k, v))
    lib_ms = device_ms(lambda: [F.scaled_dot_product_attention(
        qt[i], kt[i], vt[i], attn_mask=mask) for i in range(layers)]) / layers
    flops = 4 * h * d * s * (s + 1) / 2
    lim = bound(tensor_bytes(q[0], k[0], v[0], seg, o, lse), flops)
    print(f"flash_fwd{B1_TAG} time ({layers} layers' inputs walked): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA with the mask "
          f"{lib_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms by "
          f"{lim['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s on live causal "
          f"pairs; {k1_plan(b, s, s, h)}")
    return kernel_row("flash_fwd" + B1_TAG, K1_SOURCE, K1_REPLACES, err, ms,
                      plain_ms, lib_ms, lim)


def tail_kernel_checks(gen: torch.Generator) -> list:
    """The rows at the chat's batch of 1: K1 on one prompt row; K4 bf16 on
    one row at the last step of a 512-slot gen cache, and its beam mode on
    one prompt (4 beams at the last of 128 slots); K8 at one row on the 7B
    shapes (gate/up in the line, wq and down printed)."""
    llm = LLAVA_V15_7B.llm
    return [check_flash_b1(gen),
            *decode_rows(gen, llm, (CHAT_LEN,), (("bf16", 1),), B1_TAG,
                         sg=CHAT_TOKENS, live=CHAT_TOKENS - 1),
            *decode_rows(gen, llm, (CHAT_LEN,), (("bf16", BEAMS),), B1_TAG,
                         sg=CHAT_BEAM_TOKENS, live=CHAT_BEAM_TOKENS - 1),
            check_int8_matmul(gen, shapes=W4_SHAPES, rows=(1,),
                              name="int8_matmul" + B1_TAG,
                              timed=(4096, 11008, 1))]


def chat_batch(session: ChatSession, question: str) -> tuple:
    """(ids, lengths) of one question as ChatSession.answer makes them."""
    ids = session.prompt_ids(question)
    return (torch.tensor([ids], dtype=torch.int32, device=DEVICE),
            torch.tensor([len(ids)], dtype=torch.int32, device=DEVICE))


def run_chat(params, kernels: dict) -> None:
    """(a) halva_tpu_torch.chat's device half at batch 1 on the bf16 tree,
    loaded once: ChatSession with SmokeTok and a seeded 336 px image, two
    greedy answers at the reference's 512 tokens, each against
    generate_greedy on the same ids and pixels, token for token; one answer
    with 4 beams at 128 tokens against generate_beam's. Prints the time to
    the first token (tower, projector and prefill), host and device ms a
    token and the K1 / K4 launches, which the `_b1` rows take."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    eos = SmokeTok.eos_token_id
    template = get_template("v1")
    session = ChatSession(params, cfg, SmokeTok(), chat_pixels(cfg),
                          template, max_new_tokens=CHAT_TOKENS)
    img = session.pixels
    total = collections.Counter()
    for qi, question in enumerate(CHAT_QUESTIONS):
        _, secs, launches = timed_run(lambda: session.answer(question))
        batch, lens = chat_batch(session, question)
        st = {}
        with torch.inference_mode():
            tok, num = generate_greedy(params, cfg, batch, img, lens,
                                       max_new_tokens=CHAT_TOKENS,
                                       eos_id=eos, loop_stats=st)
            ttft = []
            for _ in range(CHAT_TTFT_RUNS):
                _, s_, _ = timed_run(lambda: _prefill_impl(params, cfg, batch,
                                                           img, lens))
                ttft.append(s_)
            first_tok, _, slen, pc, pseg = _prefill_impl(params, cfg, batch,
                                                         img, lens)
            state, bodies = decode_loop(params, cfg, first_tok, slen, pc,
                                        pseg, CHAT_TOKENS, -1)
            dev = {}
            for at in CHAT_SLOTS:
                state.step.fill_(at)
                dev[at] = device_ms(bodies[0])
            del state, bodies, pc
        steps = st["steps"]
        expect_launches(launches, {"flash_fwd": layers,
                                   "decode_attn": layers * steps},
                        f"chat's greedy answer {qi + 1} (B=1, {steps} steps)")
        total.update(launches)
        same = (torch.equal(session.last["tokens"], tok.cpu())
                and torch.equal(session.last["num"], num.cpu()))
        host = ((st["loop_s"] - st["first_step_s"] - st["capture_s"])
                / (steps - 1) * 1e3)
        n = int(num[0])
        ok = same and in_vocab(tok, cfg, eos) and steps >= 2
        print(f"chat answer {qi + 1} (ChatSession, B=1, bf16 llava-v1.5-7b, "
              f"{len(session.last['ids'])} prompt ids, {int(slen[0])} "
              f"spliced): {n} tokens of the {CHAT_TOKENS} budget (random "
              f"weights: the budget, not an answer length) in {secs:.3f} s; "
              f"time to the first token (tower, projector, prefill) "
              f"{statistics.median(ttft) * 1e3:.2f} ms (median of "
              f"{CHAT_TTFT_RUNS}); host {host:.3f} ms a token (graph "
              f"replays), device "
              + ", ".join(f"{ms:.3f} ms at gen slot {at}"
                          for at, ms in dev.items())
              + f" ({gpu_line()}); idle {max(0.0, 1 - dev[CHAT_SLOTS[0]] / host):.1%}"
              f" of the host clock at slot {CHAT_SLOTS[0]}; capture "
              f"{st['capture_s'] * 1e3:.1f} ms; tokens == generate_greedy's "
              f"on the same ids and pixels {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"chat answer {qi + 1} differs from "
                                 "generate_greedy")
    record(kernels, dict(total), "flash_fwd", "decode_attn", tag=B1_TAG)
    bsession = ChatSession(params, cfg, SmokeTok(), chat_pixels(cfg),
                           template, max_new_tokens=CHAT_BEAM_TOKENS,
                           num_beams=BEAMS)
    question = CHAT_QUESTIONS[0]
    batch, lens = chat_batch(bsession, question)
    with torch.inference_mode():
        main, _, _ = beam_routes(params, cfg, (batch, img, lens), False, "")
    if main != "decode_attn_beam":
        raise AssertionError(f"chat beams: beam_route='auto' took {main}, "
                             "where K4's beam mode was expected")
    _, secs, launches = timed_run(lambda: bsession.answer(question))
    stats = {}
    with torch.inference_mode():
        tok, num = generate_beam(params, cfg, batch, img, lens,
                                 max_new_tokens=CHAT_BEAM_TOKENS, eos_id=eos,
                                 num_beams=BEAMS, beam_route="auto",
                                 stats=stats)
    expect_launches(launches, {"flash_fwd": layers,
                               main: layers * stats["steps"]},
                    f"chat's {BEAMS}-beam answer (B=1)")
    record(kernels, launches, main, tag=B1_TAG)
    same = (torch.equal(bsession.last["tokens"], tok.cpu())
            and torch.equal(bsession.last["num"], num.cpu()))
    print(f"chat answer with {BEAMS} beams (B=1, route auto -> {main}): "
          f"{int(num[0])} tokens of the {CHAT_BEAM_TOKENS} budget, "
          f"{stats['steps']} steps in {secs:.3f} s "
          f"({secs / stats['steps'] * 1e3:.3f} ms a step with the prefill); "
          f"tokens == generate_beam's {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("chat beams differ from generate_beam")


def run_chat_int8(q8, kernels: dict) -> None:
    """(b) ChatSession on the int8 tree at batch 1, one greedy answer on
    each of its two routes, each against generate_greedy on that route:
    first W8A8 (CHAT_W8A8_TOKENS), the route `python -m halva_tpu_torch.chat
    --quant int8` takes by default (HALVA_W8A8 on: int8_dense,
    torch._int_mm, no K8 launch); then weight-only (CHAT_INT8_TOKENS,
    HALVA_W8A8=0: K8 for every int8 dense). On the weight-only route the
    answer's K8 launches are
    split inside that run, read around its one prefill call: the prefill's
    (the tower, the projector, the LLM pass over the prompt) and the decode
    steps' at 1 row, which the `int8_matmul_b1` row takes. The switch is
    restored."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    eos = SmokeTok.eos_token_id
    vit = cfg.vision
    tower_run = cfg.mm_vision_select_layer % (vit.num_layers + 1)
    tower = (count_denses(q8["vision"]["layers"], "kernel_q")
             // vit.num_layers * tower_run)
    proj = count_denses(q8["projector"], "kernel_q")
    per_pass = count_denses(q8["llm"]["layers"], "kernel_q") + count_denses(
        q8["llm"]["lm_head"], "kernel_q")
    question = CHAT_QUESTIONS[0]
    prefill = generate_mod._prefill_impl
    was = quant.w8a8_enabled()
    try:
        for route, on, budget in (
                ("W8A8, the CLI's default", True, CHAT_W8A8_TOKENS),
                ("weight-only, HALVA_W8A8=0", False, CHAT_INT8_TOKENS)):
            quant.set_w8a8(on)
            session = ChatSession(q8, cfg, SmokeTok(), chat_pixels(cfg),
                                  get_template("v1"), max_new_tokens=budget)
            batch, lens = chat_batch(session, question)
            with torch.inference_mode():
                _, prefill_s, _ = timed_run(lambda: prefill(
                    q8, cfg, batch, session.pixels, lens))
            pre = []

            def prefill_rec(*a, **k):
                before = _kernels.launches["int8_matmul"]
                out = prefill(*a, **k)
                pre.append(_kernels.launches["int8_matmul"] - before)
                return out

            with mock.patch.object(generate_mod, "_prefill_impl",
                                   prefill_rec):
                _, secs, launches = timed_run(
                    lambda: session.answer(question))
            st = {}
            with torch.inference_mode():
                tok, num = generate_greedy(q8, cfg, batch, session.pixels,
                                           lens, max_new_tokens=budget,
                                           eos_id=eos, loop_stats=st)
            steps = st["steps"]
            want = {"flash_fwd": layers, "decode_attn": layers * steps}
            if not on:
                want["int8_matmul"] = tower + proj + (1 + steps) * per_pass
            expect_launches(launches, want, f"int8 chat answer (B=1, "
                            f"{route} route, {steps} steps)")
            same = (torch.equal(session.last["tokens"], tok.cpu())
                    and torch.equal(session.last["num"], num.cpu()))
            ok = same and in_vocab(tok, cfg, eos) and pre == [
                0 if on else tower + proj + per_pass]
            host = (st["loop_s"] - st["first_step_s"] - st["capture_s"]) / (
                steps - 1) * 1e3
            k8 = ""
            if not on:
                row1 = launches["int8_matmul"] - pre[0]
                kernels["int8_matmul" + B1_TAG]["launches"] = row1
                ok = ok and row1 == steps * per_pass
                k8 = (f"; K8 launches {launches['int8_matmul']}: {pre[0]} in "
                      f"the answer's prefill call ({tower} in the tower, "
                      f"{tower_run} layers x 6 at one image's "
                      f"{vit.num_positions} rows, {proj} in the projector, "
                      f"{per_pass} in the LLM pass), {row1} after it at 1 "
                      f"row ({steps} steps x {per_pass} denses with lm_head)")
            print(f"int8 chat answer (ChatSession, B=1, {route} route): "
                  f"{int(num[0])} tokens of the {budget} budget"
                  f"{' (reduced: 128)' if on else ''} in "
                  f"{secs:.3f} s, prefill {prefill_s * 1e3:.2f} ms, host "
                  f"{host:.3f} ms a token ({gpu_line()}){k8}; tokens == "
                  f"generate_greedy's on this route {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8 chat, {route} route: tokens or "
                                     "K8 launches differ")
    finally:
        quant.set_w8a8(was)


class SuiteGenerator(runner_mod.BatchedGenerator):
    """evals/runner.BatchedGenerator with a seeded processed image for each
    image path (the card's machine has no Pillow to decode one); a request
    without an image keeps the runner's zero image."""

    def _load_image(self, req):
        if req.image_path is None:
            return super()._load_image(req)
        size = self.proc.crop_size
        rng = np.random.RandomState(zlib.crc32(req.image_path.encode()))
        return rng.randn(3, size, size).astype(np.float32)


def suite_requests(root: str) -> dict:
    """Three batches of SUITE_BATCH requests from the runner's own builders:
    CHAIR's captions, POPE-shaped yes/no questions and HallusionBench-shaped
    rows (SUITE_TEXT_ONLY of them text-only). {shape: (requests, budget)}."""
    images = os.path.join(root, "val2014")
    caption = runner_mod.chair_requests(images)[:SUITE_BATCH]
    qfile = os.path.join(root, "pope_questions.jsonl")
    with open(qfile, "w") as f:
        for i in range(SUITE_BATCH):
            obj = POPE_OBJECTS[i % len(POPE_OBJECTS)]
            f.write(json.dumps({"question_id": i,
                                "image": f"COCO_val2014_{i:012d}.jpg",
                                "text": f"Is there a {obj} in the image?",
                                "category": "adversarial"}) + "\n")
    yesno = runner_mod.vqa_requests(qfile, images)
    rows = [{"visual_input": int(i >= SUITE_TEXT_ONLY), "category": "VS",
             "subcategory": "chart", "set_id": i, "figure_id": 0,
             "question_id": 0, "filename": f"./VS/chart/{i}_0.png",
             "question": f"Is the bar of series {i} higher than 50 in this "
                         "chart?", "gt_answer": "1"}
            for i in range(SUITE_BATCH)]
    mixed = runner_mod.hallusion_requests(rows, os.path.join(root, "hb"))
    return {"caption": (caption, SUITE_CAPTION_TOKENS),
            "yes/no": (yesno, SUITE_YESNO_TOKENS),
            "mixed": (mixed, SUITE_YESNO_TOKENS)}


def run_suite(q4, load_s: float) -> dict:
    """(c) The one-load eval suite's device half on the int4g tree with int4
    prompt KV at batch 80 (the README's eval command, not
    scripts/torch_eval_suite.sh's batch 8): three drains of 80 requests
    through SuiteGenerator with SmokeTok, each batch's host wall time
    (BatchedGenerator.last_stats["device_s"]: one cold generate call, its
    capture and eager first step in it) and the share of its prefill (the
    same batch prefilled again, timed alone); then a projection of each
    benchmark's host wall time at its public size, and of the whole suite,
    beside the loader's warm int4g load. Returns the caption batch's
    imgs/s."""
    cfg = LLAVA_V15_7B
    layers = cfg.llm.num_layers
    proc = processor_for_vision(cfg.vision)
    root = os.path.join(REPO, "build", f"smoke_suite_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    measured = {}
    try:
        for shape, (reqs, budget) in suite_requests(root).items():
            gen = SuiteGenerator(q4, cfg, SmokeTok(), proc,
                                 image_aspect_ratio=cfg.image_aspect_ratio,
                                 batch_size=SUITE_BATCH,
                                 max_new_tokens=budget, kv_quant="int4")
            texts, secs, launches = timed_run(lambda: gen.run(reqs))
            batch_s = gen.last_stats["device_s"]
            steps = launches.get("decode_attn_kv4", 0) // layers
            expect_launches(launches, {
                "flash_fwd": layers, "decode_attn_kv4": layers * steps,
                **w4_mm_launches(SUITE_BATCH, 7 * layers * steps)},
                f"suite's {shape} batch ({steps} steps)")
            ids_all = [gen._tokenize(r) for r in reqs]
            order = sorted(range(len(reqs)), key=lambda i: len(ids_all[i]))
            _, bids, imgs, blens, _ = gen._build_batch(reqs, ids_all, order,
                                                       None)
            args = [torch.from_numpy(a).to(DEVICE) for a in (bids, imgs,
                                                              blens)]
            with torch.inference_mode():
                _, prefill_s, _ = timed_run(lambda: _prefill_impl(
                    q4, cfg, *args, kv_quant="int4"))
            text_only = sum(r.image_path is None for r in reqs)
            ok = (len(texts) == SUITE_BATCH and all(texts)
                  and 1 <= steps <= budget)
            measured[shape] = (batch_s, prefill_s, steps)
            print(f"suite {shape} batch ({len(reqs)} requests, {text_only} "
                  f"text-only, prompts of {min(blens)}-{max(blens)} ids "
                  f"padded to {bids.shape[1]}, budget {budget}): "
                  f"{batch_s:.3f} s of host wall time in one cold generate "
                  f"call (its capture and eager first step in it; {secs:.3f}"
                  f" s with tokenizing and the seeded images), {steps} decode"
                  f" steps;"
                  f" prefill alone {prefill_s * 1e3:.1f} ms = "
                  f"{prefill_s / batch_s:.1%} of the batch, decode "
                  f"{(batch_s - prefill_s) / steps * 1e3:.3f} ms a step; "
                  f"{SUITE_BATCH / batch_s:.3f} imgs/s ({gpu_line()}); every "
                  f"row answered {all(texts)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"suite {shape} batch: rows unanswered")
            del gen, args
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = prefill = 0.0
    parts = []
    for name, count, shape, source in SUITE_COUNTS:
        batch_s, prefill_s, _ = measured[shape]
        n = -(-count // SUITE_BATCH)
        total += n * batch_s
        prefill += n * prefill_s
        parts.append(f"{name} {count} ({source}): {n} x {shape} = "
                     f"{n * batch_s:.1f} s")
    print(f"suite PROJECTION, not a measurement (each benchmark's batches "
          f"of {SUITE_BATCH} at its public size x the host wall time of one "
          f"cold batch of its shape; the README's batch {SUITE_BATCH}, not "
          f"torch_eval_suite.sh's 8; captions at {SUITE_CAPTION_TOKENS} "
          f"tokens, yes/no at {SUITE_YESNO_TOKENS}, an assumed answer length "
          f"where the script's budgets are 64 for POPE and MME and 1024 for "
          f"AMBER): " + "; ".join(parts)
          + f"; the suite {total:.1f} s of host wall time, "
          f"{prefill / total:.1%} of it prefill, after one load (the "
          f"loader's warm int4g load {load_s:.1f} s) ({gpu_line()})")
    return {"caption_ips": SUITE_BATCH / measured["caption"][0]}


# the 13B launch scripts' train steps: (preset, script, its --max-length,
# the TrainConfig fields its flags set)
RECIPE_PEAKS = (
    ("llava-v1.5-13b", "scripts/torch_halva_13b.sh", 2048,
     dict(learning_rate=5e-6, mm_projector_lr=0.0, loss_alpha=0.5)),
    ("vila-13b-384", "scripts/torch_halva_vila_13b.sh", 4096,
     dict(learning_rate=2.5e-5, mm_projector_lr=2.5e-5, loss_alpha=0.2)),
)


def recipe_peaks() -> None:
    """The card's memory under the 13B launch scripts' train step on one
    card (MESH_MODEL=1): the DPA micro-step as train/run.py builds it from
    each script's flags (LoRA r=128 alpha=256, remat, whole logits, AdamW,
    the projector trained and its initial copy in the reference where
    --mm-projector-lr is set), per-device batch 2, every row at the
    script's --max-length text tokens (the longest the dataset keeps), at
    full width and depth on random weights. Two micro-steps at grad_accum
    2, the second applying the update (its AdamW moments allocated): the
    peak of max_memory_allocated over them."""
    total = torch.cuda.get_device_properties(0).total_memory
    for name, script, max_len, fields in RECIPE_PEAKS:
        cfg = PRESETS[name]
        params = new_tree(cfg, name)
        policy = add_lora(params, torch.Generator(device=DEVICE).manual_seed(
            1), rank=128, alpha=256.0)
        del params
        tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400,
                           warmup_ratio=0.03, weight_decay=0.0, **fields)
        extra = (r"^projector/",) if tcfg.mm_projector_lr else ()
        trainable, frozen, opt, opt_state, ref = state_and_ref(policy, tcfg,
                                                              extra)
        del policy
        step, _ = dpa_step_fns(cfg, tcfg, opt)
        base = torch.cuda.memory_allocated()
        peak, times = 0, []
        for seed in range(2):
            batch = train_batch(cfg, seed, text=max_len)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainable, opt_state, m = step(trainable, frozen, ref, opt_state,
                                           batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak = max(peak, torch.cuda.max_memory_allocated())
            vals = [float(x) for x in m]
            if not (all(np.isfinite(vals)) and vals[3] > 0):
                raise AssertionError(f"{name}: a loss is not finite")
            del batch
        spliced = max_len - 1 + cfg.num_image_tokens
        print(f"recipe peak {name} ({script}, one card): micro-step at "
              f"{TRAIN_B} x {max_len} text tokens ({spliced} spliced, "
              f"{2 * TRAIN_B} pos+neg and {TRAIN_B} ref rows), "
              f"{opt.updates} update(s) applied: peak "
              f"{peak / 2**30:.2f} GiB allocated of the card's "
              f"{total / 2**30:.2f} GiB (the tree, LoRA and state "
              f"{base / 2**30:.2f} GiB before the steps); micro-steps "
              + ", ".join(f"{t:.2f}" for t in times) + f" s ({gpu_line()}) "
              f"{'ok' if peak < total else 'FAIL'}")
        del trainable, frozen, opt, opt_state, ref, step
        torch.cuda.empty_cache()


def compare_bench(suite: dict, bench: dict) -> None:
    """The suite's caption batch beside `python -m halva_tpu_torch.bench`
    in the same run."""
    ips, bench_ips = suite["caption_ips"], bench["value"]
    off = abs(ips / bench_ips - 1)
    print(f"suite caption batch {ips:.3f} imgs/s against the bench's "
          f"{bench_ips} imgs/s ({ips / bench_ips:.3f}x): "
          + ("within 10 %" if off <= 0.10 else
             "more than 10 % apart: the bench times 3 batches after a "
             "warm-up with W4A8 on and 48-slot prompts; the suite batch is "
             "one cold drain through the runner (bucketed prompts, capture "
             "in its time)")
          + f" ({gpu_line()})")


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
        fold = check_fold(gen)
        beam_route_sweep(gen)
        print(json.dumps({"fold_kernels": fold}))
        return
    if sys.argv[1:] == ["--gemm-only"]:
        checked = [check_w4_gemm(gen), check_int8_matmul(gen)]
        check_w4_gemm_dx(gen)
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
    if sys.argv[1:] == ["--train-cli-only"]:
        params = new_tree(LLAVA_V15_7B, "llava-v1.5-7b")
        launches = collections.defaultdict(dict)
        train_ms = run_train(params, launches, compare=False)
        torch.cuda.empty_cache()
        run_train_cli(params, LLAVA_V15_7B, train_ms,
                      then=lambda base, cli_cfg: run_pack(
                          params, LLAVA_V15_7B, launches, base, cli_cfg))
        return
    if sys.argv[1:] == ["--pack-only"]:
        params = new_tree(LLAVA_V15_7B, "llava-v1.5-7b")
        launches = collections.defaultdict(dict)
        root = os.path.join(REPO, "build", f"smoke_pack_{os.getpid()}")
        try:
            base = os.path.join(root, "base")
            cli_cfg, save_s = cli_base(params, LLAVA_V15_7B, base)
            print(f"packed phase: save_params of the bf16 tree's first "
                  f"{CLI_LAYERS} layers in {save_s:.1f} s")
            rows = run_pack(params, LLAVA_V15_7B, launches, base, cli_cfg)
        finally:
            PRESETS.pop(CLI_PRESET, None)
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"pack_kernels": rows, "pack_launches": {
            name: k["launches"] for name, k in sorted(launches.items())}}))
        return
    if sys.argv[1:] == ["--gemma-only"]:
        # the head-dim-128 rows of K1 and K4 beside the 256 ones, one card
        base = [check_flash(gen), check_decode(gen)]
        rows = gemma_kernel_checks(gen)
        kernels = collections.defaultdict(dict, {k["name"]: k for k in rows})
        run_gemma(kernels)
        keys = ("name", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"gemma_kernels": [{k: kern.get(k) for k in keys}
                                            for kern in base + rows]}))
        return
    if sys.argv[1:] == ["--gemma-train-only"]:
        # K2 and K3 at 256, then the train phase on a fresh Gemma tree
        rows = [check_gemma_flash(gen), *check_gemma_flash_bwd(gen)]
        kernels = collections.defaultdict(dict, {k["name"]: k for k in rows})
        params = new_tree(LLAVA_GEMMA_2B, "llava-gemma-2b (VILA's "
                          "llava_gemma: Gemma-2B under CLIP ViT-L/14-336)")
        run_gemma_train(params, kernels)
        keys = ("name", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"gemma_train_kernels": [
            {k: kern.get(k) for k in keys} for kern in rows]}))
        return
    if sys.argv[1:] == ["--vila-only"]:
        rows = vila_kernel_checks(gen)
        kernels = collections.defaultdict(dict, {k["name"]: k for k in rows})
        run_vila(kernels)
        keys = ("name", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"vila_kernels": [{k: kern.get(k) for k in keys}
                                           for kern in rows]}))
        return
    if sys.argv[1:] == ["--mesh-only"]:
        rows = mesh_kernel_checks(gen)
        kernels = collections.defaultdict(dict, {k["name"]: k for k in rows})
        params = new_tree(LLAVA_V15_7B, "llava-v1.5-7b")
        keep = {}
        run_train(params, kernels, compare=False, keep=keep)
        torch.cuda.empty_cache()
        run_train_world_of_one(params, keep)
        torch.cuda.empty_cache()
        train = mesh_train_inputs(params)
        shards = tp2_shards(params)
        q4 = quantize_int4g(params)
        del params
        torch.cuda.empty_cache()
        inputs = make_inputs(LLAVA_V15_7B)
        with torch.inference_mode():
            generate_greedy(q4, LLAVA_V15_7B, *inputs, max_new_tokens=2,
                            eos_id=-1, kv_quant="int4")  # warm-up
            tokens, _ = generate_greedy(q4, LLAVA_V15_7B, *inputs,
                                        max_new_tokens=NEW_TOKENS, eos_id=-1,
                                        kv_quant="int4")
        run_mesh(q4, shards, tokens, kernels, train)
        keys = ("name", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"mesh_kernels": [{k: kern.get(k) for k in keys}
                                           for kern in rows]}))
        return
    if sys.argv[1:] == ["--recipe-peak-only"]:
        recipe_peaks()
        return
    if sys.argv[1:] == ["--serve-variants-only"]:
        params = new_tree(LLAVA_V15_7B, "llava-v1.5-7b")
        run_sampling_bf16(params, LLAVA_V15_7B)
        q4 = quantize_int4g(params)
        del params
        torch.cuda.empty_cache()
        launches = collections.defaultdict(dict)
        run_serve_variants(q4, launches)
        print(json.dumps({"serve_variant_launches": {
            name: k["launches"] for name, k in sorted(launches.items())}}))
        return
    quant_only = sys.argv[1:] == ["--quant-only"]
    if sys.argv[1:] and not quant_only:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    clock("build")
    checked = [check_w4_gemm(gen), check_int8_matmul(gen)]
    check_w4_gemm_dx(gen)
    gemm_summary(checked)
    clock("K7/K8 checks")
    if not quant_only:
        for what, check in (
                ("K1-K3", flash_checks),
                ("K4", lambda g: [check_decode(g), *check_decode_quant(g)]),
                ("K5", check_fold), ("K6", lambda g: [check_w4(g)]),
                ("head dim 256", gemma_kernel_checks),
                ("VILA-13B", vila_kernel_checks), ("mesh", mesh_kernel_checks),
                ("batch 1", tail_kernel_checks)):
            checked += check(gen)
            clock(f"{what} checks")
    kernels = {k["name"]: k for k in checked}
    if quant_only:  # the other kernels' launches are counted, not kept
        kernels = collections.defaultdict(dict, kernels)
    print(f"route: attn_impl='auto' at head dim {CFG.llm.head_size} -> "
          f"{kernel_route('auto', CFG.llm.head_size)}, at head dim 256 -> "
          f"{kernel_route('auto', 256)}, at head dim 64 -> "
          f"{kernel_route('auto', 64)} (ops/attention.kernel_route, from "
          "the config alone, with or without grad, on either device: K1-K5 "
          "and the "
          "packed-int4 decode step take head dims 128 and 256; a caller "
          "who names 'kernel' still gets the wrappers' ValueError)")
    if quant_only:
        params = new_tree(LLAVA_V15_7B, "llava-v1.5-7b")
    else:
        params = run_bf16(kernels)
        clock("bf16 main path")
        run_chat(params, kernels)
        clock("chat at batch 1")
        run_beam_spec_bf16(params, kernels)
        clock("bf16 beams and speculative decode")
        keep = {}
        train_ms = run_train(params, kernels, keep=keep)
        torch.cuda.empty_cache()
        clock("bf16 train step")
        run_train_world_of_one(params, keep)
        torch.cuda.empty_cache()
        clock("mesh-train (a)")
        run_graph_loops(params, LLAVA_V15_7B, int4=False)
        run_sampling_bf16(params, LLAVA_V15_7B)
        clock("bf16 graph loops and sampling")
        load_s = run_loader(params, LLAVA_V15_7B)
        clock("loader and converter")
        run_train_cli(params, LLAVA_V15_7B, train_ms,
                      then=lambda base, cli_cfg: run_pack(
                          params, LLAVA_V15_7B, kernels, base, cli_cfg))
        clock("train CLI and packed training")
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
    if not quant_only:  # the two-rank phase's shards, made on the card
        shards = tp2_shards(params)
        train = mesh_train_inputs(params)
    q4 = quantize_int4g(params)
    del params  # the bf16 tree is freed here
    torch.cuda.empty_cache()
    clock("quantized trees")
    run_int8_serving(q8, kernels)
    run_chat_int8(q8, kernels)
    run_train_quant(q8, kernels, "int8", W8A8_FLOOR_FACTOR)
    del q8
    torch.cuda.empty_cache()
    run_train_quant(nf4, kernels, "NF4", TRAIN_FLOOR_FACTOR)
    del nf4
    torch.cuda.empty_cache()
    clock("int8 serving, int8 and NF4 training")
    print("route: dense on kernel_q4p at prefill and train M -> dequantize "
          "+ torch.matmul (K7 is measured beside it in check_w4_gemm and "
          "routed only where it wins); kernel_q4 -> nf4_dense; kernel_q -> "
          "int8_dense (W8A8 on)")
    run_train_quant(q4, kernels, "int4g", W8A8_FLOOR_FACTOR)
    clock("int4g training")
    greedy_tokens = run_int4g(q4, kernels)
    clock("int4g main path")
    run_beam_spec_int4g(q4, kernels, greedy_tokens)
    clock("int4g beams, speculative decode, batch 80")
    if not quant_only:
        suite = run_suite(q4, load_s)
        clock("eval suite's device half")
        run_mesh(q4, shards, greedy_tokens, kernels, train)
        del shards, train
        torch.cuda.empty_cache()
        clock("mesh")
        run_graph_loops(q4, LLAVA_V15_7B, int4=True)
        clock("int4g graph loops")
        run_serve_variants(q4, kernels)
        clock("serve variants")
    del q4
    torch.cuda.empty_cache()
    if not quant_only:
        for name, run in (("mistral-7b", run_mistral), ("mpt-7b", run_mpt)):
            t0 = time.perf_counter()
            run(kernels)
            torch.cuda.empty_cache()
            print(f"{name} phase: {time.perf_counter() - t0:.1f} s")
            clock(name)
        run_gemma(kernels)
        torch.cuda.empty_cache()
        clock("llava-gemma-2b")
        run_vila(kernels)
        torch.cuda.empty_cache()
        clock("vila-13b-384")
        compare_bench(suite, run_bench())
        clock("bench")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "halva_tpu"))
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    print("imports: neither jax nor any module of the JAX package (this "
          "process; the two mesh ranks checked their own)")
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
