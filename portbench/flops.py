"""Operations and bytes a call needs, from its shapes.

The kernels' counts are those of chip_smoke.py's roofline lines, frozen
here: a kernel's least time is the larger of its bytes over the HBM rate
and its operations over the bf16 tensor-core rate (`bound_s`), counting
live rows (segment id != 0) and live (query, key) pairs only. Each input
byte is read once and each output byte written once.

- K1 (flash forward): 2 * D FLOP per live pair for Q K^T and as many for
  P V; bytes of the live rows of q, k, v, o, the fp32 log-sum-exp, and
  the segment ids.
- K2 (flash backward, dQ): S, dP and dQ, 6 * D FLOP a pair; q, k, v, dO,
  lse, delta, segment ids in, dQ out.
- K3 (flash backward, dK and dV): S, dP, dV and dK, 8 * D FLOP a pair; the
  same inputs, dK and dV out.
- K4 (decode attention, one step of one layer): 4 * D FLOP per query head
  and live cache position; the live prompt and generated cache rows (k and
  v, bf16) and q in, the output out.

The model FLOPs behind `train.mfu` and `eval.mfu` count the work the model
needs and nothing that a program repeats: every dense product of every live
token, the attention products of live pairs, the head where its logits are
used, the tower once per distinct image; in training the frozen reference
forward, the policy's forwards, and the backward through the frozen base
(dX only) and into the LoRA factors; never a recomputation.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

# H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOP_S, nbytes / PEAK_HBM_BYTES_S)


def causal_pairs(n: int, window: Optional[int] = None) -> int:
    """Live (query, key) pairs of one causal row of n tokens; a sliding
    window keeps the last `window` keys of each query."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    w = window
    return w * (w + 1) // 2 + (n - w) * w


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def attn_dims(llm: dict):
    """(heads, KV heads, head dim, sliding window) of an LLM configuration."""
    h = llm["num_heads"]
    return (h, llm.get("num_kv_heads") or h,
            llm.get("head_dim") or llm["hidden_size"] // h,
            llm.get("sliding_window"))


def _io_bytes(lens: Sequence[int], s_pad: int, h: int, kvh: int, d: int):
    live = sum(lens)
    q = live * h * d * 2
    kv = 2 * live * kvh * d * 2
    seg = len(lens) * s_pad * 4
    lse = live * h * 4
    return live, q, kv, seg, lse


def flash_fwd(lens: Sequence[int], s_pad: int, h: int, kvh: int, d: int,
              window: Optional[int] = None):
    """(flops, bytes) of one K1 call over rows of `lens` live tokens."""
    pairs = sum(causal_pairs(n, window) for n in lens)
    _, q, kv, seg, lse = _io_bytes(lens, s_pad, h, kvh, d)
    return 4 * h * d * pairs, q + kv + seg + q + lse


def flash_bwd_dq(lens, s_pad, h, kvh, d, window=None):
    pairs = sum(causal_pairs(n, window) for n in lens)
    _, q, kv, seg, lse = _io_bytes(lens, s_pad, h, kvh, d)
    # q, k, v, dO, lse, delta, seg in; dQ out
    return 6 * h * d * pairs, q + kv + q + 2 * lse + seg + q


def flash_bwd_dkv(lens, s_pad, h, kvh, d, window=None):
    pairs = sum(causal_pairs(n, window) for n in lens)
    _, q, kv, seg, lse = _io_bytes(lens, s_pad, h, kvh, d)
    return 8 * h * d * pairs, q + kv + q + 2 * lse + seg + kv


def decode_attn(prompt_lens: Sequence[int], gen_live: int, h: int, kvh: int,
                d: int):
    """(flops, bytes) of one K4 call: one query token a row over its live
    prompt cache and `gen_live` generated positions of every row."""
    rows = len(prompt_lens)
    live = sum(prompt_lens) + rows * gen_live
    cache = live * kvh * d * 2 * 2
    q = rows * h * d * 2
    return 4 * h * d * live, cache + 2 * q + rows * 4


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------


def llm_dense_flops(llm: dict) -> int:
    """FLOP of one token through the decoder's dense products (no head)."""
    d, f = llm["hidden_size"], llm["intermediate_size"]
    h = llm["num_heads"]
    kvh = llm.get("num_kv_heads") or h
    dh = llm.get("head_dim") or d // h
    attn = d * h * dh + 2 * d * kvh * dh + h * dh * d
    mlp = (3 if llm["gated_mlp"] else 2) * d * f
    return 2 * llm["num_layers"] * (attn + mlp)


def lora_flops(llm: dict, rank: int) -> int:
    """FLOP of one token through every LoRA branch of the decoder."""
    d, f = llm["hidden_size"], llm["intermediate_size"]
    h = llm["num_heads"]
    kvh = llm.get("num_kv_heads") or h
    dh = llm.get("head_dim") or d // h
    dims = [(d, h * dh), (d, kvh * dh), (d, kvh * dh), (h * dh, d),
            (d, f), (f, d)]
    if llm["gated_mlp"]:
        dims.append((d, f))
    return 2 * llm["num_layers"] * sum(rank * (i + o) for i, o in dims)


def head_flops(llm: dict) -> int:
    return 2 * llm["hidden_size"] * llm["vocab_size"]


def attn_flops(llm: dict, pairs: int) -> int:
    """Q K^T and P V over `pairs` live pairs, every layer."""
    h = llm["num_heads"]
    dh = llm.get("head_dim") or llm["hidden_size"] // h
    return 4 * h * dh * pairs * llm["num_layers"]


def vision_flops(model: dict, images: int) -> int:
    """The tower up to the selected layer and the projector, per image."""
    v = model["vision"]
    d, f = v["hidden_size"], v["intermediate_size"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    layers = model["mm_vision_select_layer"] % (v["num_layers"] + 1)
    patch = 2 * (n - 1) * 3 * v["patch_size"] ** 2 * d
    per_layer = 2 * n * (4 * d * d + 2 * d * f) + 4 * d * n * n
    tokens = n - 1
    llm_d = model["llm"]["hidden_size"]
    proj = 2 * tokens * (d * llm_d + llm_d * llm_d)
    return images * (patch + layers * per_layer + proj)


def forward_flops(llm: dict, lens: Iterable[int], lora_rank: int = 0,
                  head_tokens: Optional[int] = None) -> int:
    """One decoder forward over rows of `lens` live tokens; the head over
    `head_tokens` positions (every live token by default)."""
    lens = list(lens)
    tokens = sum(lens)
    window = llm.get("sliding_window")
    pairs = sum(causal_pairs(n, window) for n in lens)
    per_token = llm_dense_flops(llm) + (lora_flops(llm, lora_rank)
                                         if lora_rank else 0)
    heads = tokens if head_tokens is None else head_tokens
    return tokens * per_token + attn_flops(llm, pairs) + heads * head_flops(
        llm)


def backward_flops(llm: dict, lens: Iterable[int], lora_rank: int) -> int:
    """The backward of a LoRA policy forward through a frozen base: dX
    through every dense, head and attention (twice the forward's products),
    and the LoRA branches' dX, dA and dB (twice their forward)."""
    lens = list(lens)
    tokens = sum(lens)
    window = llm.get("sliding_window")
    pairs = sum(causal_pairs(n, window) for n in lens)
    return (tokens * (llm_dense_flops(llm) + head_flops(llm)
                      + 2 * lora_flops(llm, lora_rank))
            + 2 * attn_flops(llm, pairs))


def train_step_flops(model: dict, pn_lens: Sequence[int],
                     ref_lens: Sequence[int], lora_rank: int) -> int:
    """One DPA micro-step: the tower once per distinct image (the pos/neg
    rows share theirs), the frozen reference forward on the reference rows,
    the policy forward on pos, neg and reference rows, and the backward of
    the policy forwards."""
    llm = model["llm"]
    images = len(pn_lens) // 2 + len(ref_lens)
    policy = list(pn_lens) + list(ref_lens)
    return (vision_flops(model, images)
            + forward_flops(llm, ref_lens)
            + forward_flops(llm, policy, lora_rank)
            + backward_flops(llm, policy, lora_rank))


def eval_batch_flops(model: dict, prompt_lens: Sequence[int],
                     served: Sequence[int]) -> int:
    """One eval batch as the model needs it: the tower per image, the
    prefill of every live spliced prompt with the head at its last
    position, then served[i] - 1 decode steps of row i, each one token
    through the decoder and the head, attending over its context."""
    llm = model["llm"]
    window = llm.get("sliding_window")
    total = vision_flops(model, len(prompt_lens))
    total += forward_flops(llm, prompt_lens, head_tokens=len(prompt_lens))
    per_token = llm_dense_flops(llm) + head_flops(llm)
    for n, k in zip(prompt_lens, served):
        for j in range(1, k):
            ctx = n + j
            if window is not None:
                ctx = min(ctx, window)
            total += per_token + attn_flops(llm, ctx)
    return total
