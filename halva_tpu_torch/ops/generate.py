"""Batched KV-cached decoding: greedy, or nucleus sampling.

Counterpart of halva_tpu/ops/generate.py, single-device path. The prefill
encodes the images, splices them into the prompts, fills the head-major
prompt cache and takes the first token; the decode loop then emits one
token per step from a small generated-token cache until every row hit EOS
or the budget. Rows with prompt length 0 are dead rows: done at step 0,
they emit eos_id.

The reference compiles both phases into one XLA program with a
`lax.while_loop`. Here the prefill runs eagerly and the decode loop is a
body over fixed-shape device tensors (`DecodeState`) that `graph_loop`
replays from a CUDA graph on the card; testing `done.all()` syncs the host
once per step, the reference's `cond`.

Sampling (temperature > 0) draws inside that body. The reference's draw,
`jax.random.categorical` under `fold_in(rng, step)`, is Gumbel-max; here the
Gumbel noise is a pure function of (seed, step, row, vocab index), a
counter-based hash in integer tensor ops keyed by the 0-d device step. So
every replay of the graph draws fresh numbers without a host read, and one
seed gives the same tokens from a graph, eagerly, and on the CPU.

Under a mesh (`generate(mesh=)`, parallel/mesh.py: one process per GPU)
every rank is given the whole batch and decodes the rows of its data index
with the single-device program, on the route its tree was placed for
(parallel/partition.place_serving): the whole tree ("data"), manual TP on
its shards with the two all-reduces of a layer ("manual_tp"), or
gather-at-use ("gather"). The tokens are then all-gathered over the data
axis, so every rank returns the whole batch's. The reference's rng rule
(halva_tpu/ops/generate.py:405-411) becomes a seed rule: data shard d
draws from seed + d * (its rows), so identical prompts on two shards draw
apart and model shards, which hold the same rows, draw in lockstep.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.constants import IMAGE_TOKEN_INDEX
from halva_tpu_torch.models import llama, llava
from halva_tpu_torch.ops import graph_loop
from halva_tpu_torch.parallel import partition
from halva_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, all_gather

Params = Dict[str, Any]


def _prefill_impl(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) right-padded, -200 image sentinel
    images: torch.Tensor,  # (B, 3, H, W)
    prompt_lengths: torch.Tensor,  # (B,) valid tokens before the splice
    attn_impl: str = "auto",
    kv_quant=False,
    tp: int = 1,
    tp_group=None,
):
    """Returns (first token (B,) int32, first logits (B, V) fp32, spliced
    lengths (B,), prompt cache in the `kv_quant` format, spliced segment
    ids (B, S + T - 1)). tp / tp_group: manual TP (llama.prefill)."""
    b, s = input_ids.shape
    dev = input_ids.device
    seg = (torch.arange(s, device=dev)[None, :]
           < prompt_lengths[:, None]).to(torch.int32)
    feats = llava.encode_images(params, cfg, images)
    sp = llava.splice_image_tokens(params, cfg, input_ids, feats, seg)
    hidden, prompt_cache = llama.prefill(
        params["llm"], cfg.llm, sp.embeds, sp.segment_ids, sp.positions,
        cache_dtype=torch.bfloat16, attn_impl=attn_impl,
        quantize_cache=kv_quant, tp=tp, tp_group=tp_group,
    )
    has_img = (input_ids == IMAGE_TOKEN_INDEX).any(dim=1)
    spliced_len = prompt_lengths + has_img.to(prompt_lengths.dtype) * (
        cfg.num_image_tokens - 1)
    last_idx = (spliced_len - 1).clamp(0, hidden.shape[1] - 1).long()
    last_hidden = hidden[torch.arange(b, device=dev), last_idx][:, None]
    first_logits = llama.lm_logits(params["llm"], cfg.llm, last_hidden)[:, 0]
    first_tok = first_logits.argmax(dim=-1).to(torch.int32)
    return first_tok, first_logits, spliced_len, prompt_cache, sp.segment_ids


_M32 = 0xFFFFFFFF
FIRST_STEP = 0x7FFFFFFF  # the step key of the first token's draw


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the constant in 16-bit
    halves, so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (lowbias32) of int64 x in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: int, step, rows: int, vocab: int,
                 device) -> torch.Tensor:
    """(rows, vocab) fp32 standard Gumbel noise, a pure function of (seed,
    step, row, vocab index); `step` is a host int or a 0-d device tensor,
    which nothing reads on the host. Uniforms carry 23 bits, so that
    (k + 0.5) / 2**23 stays exact in fp32 and below 1: the noise is
    finite."""
    if isinstance(step, torch.Tensor):
        step = step.long()
    key = _hash32(_hash32(torch.full((), seed & _M32, dtype=torch.long,
                                     device=device)) ^ (step & _M32))
    ctr = torch.arange(rows * vocab, dtype=torch.long,
                       device=device).view(rows, vocab)
    bits = _hash32(_hash32(ctr ^ key) ^ _hash32(key ^ 0x9E3779B9))
    u = ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def nucleus_logits(logits: torch.Tensor, temperature: float,
                   top_p: float) -> torch.Tensor:
    """logits / temperature with every token outside the nucleus at -inf:
    the cutoff is the smallest logit of the shortest sorted prefix whose
    probability before the token is < top_p; ties with it stay in
    (halva_tpu/ops/generate.py:_select_token)."""
    logits = logits.float() / temperature
    if top_p < 1.0:
        srt = logits.sort(dim=-1, descending=True).values
        probs = srt.softmax(dim=-1)
        keep = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits,
                             torch.full_like(logits, float("-inf")))
    return logits


def _select_token(logits: torch.Tensor, temperature: float, top_p: float,
                  seed: int, step) -> torch.Tensor:
    """Greedy (temperature 0) or nucleus sampling, (B,) int32: argmax of
    the filtered logits plus this step's Gumbel noise."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    filtered = nucleus_logits(logits, temperature, top_p)
    b, v = filtered.shape
    noise = gumbel_noise(seed, step, b, v, filtered.device)
    return (filtered + noise).argmax(dim=-1).to(torch.int32)


def init_gen_cache_like(cfg_llm, rows: int, max_new_tokens: int,
                        prompt_cache: Params, tp: int = 1) -> Params:
    """Generated-token cache on the prompt cache's device: int8 for an int8
    or int4 prompt cache (both carry `k_scale`), the prompt dtype
    otherwise; the kv_heads/tp local heads under manual TP."""
    k = prompt_cache["k4" if "k4" in prompt_cache else "k"]
    return llama.init_gen_cache(cfg_llm, rows, max_new_tokens, dtype=k.dtype,
                                device=k.device,
                                quantized="k_scale" in prompt_cache, tp=tp)


class DecodeState(NamedTuple):
    """The decode loop's state, advanced in place by its body."""
    tokens: torch.Tensor  # (B, max_new) int32 emitted tokens
    cur: torch.Tensor  # (B,) int32 token to emit at this step
    done: torch.Tensor  # (B,) bool
    step: torch.Tensor  # () int64 decode step = gen slot to write
    gen_cache: Params  # (L, B, KVH, Sg, Dh) leaves


def decode_loop(
    params: Params,
    cfg: LlavaConfig,
    first_tok: torch.Tensor,
    spliced_len: torch.Tensor,
    prompt_cache: Params,
    prompt_seg: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    attn_impl: str = "auto",
    temperature: float = 0.0,
    top_p: float = 1.0,
    seed: int = 0,
    tp: int = 1,
    tp_group=None,
) -> Tuple[DecodeState, List[Callable[[], None]]]:
    """The decode loop's state, made before any step (a CUDA graph captures
    the body over it), and its body: one step, in place — emit `cur`
    (eos_id on done rows), embed it, `decode_step` at the device step,
    select the next token (`_select_token` keyed by that step), step + 1 —
    reading nothing on the host. tp / tp_group: manual TP
    (llama.decode_step)."""
    b = first_tok.shape[0]
    dev = first_tok.device
    state = DecodeState(
        tokens=torch.zeros((b, max_new_tokens), dtype=torch.int32,
                           device=dev),
        cur=first_tok.to(torch.int32).clone(),
        done=spliced_len == 0,  # dead rows
        step=torch.zeros((), dtype=torch.long, device=dev),
        gen_cache=init_gen_cache_like(cfg.llm, b, max_new_tokens,
                                      prompt_cache, tp))

    tokens, cur, done, step, gen_cache = state

    def body():
        tok = torch.where(done, torch.full_like(cur, eos_id), cur)
        tokens.index_copy_(1, step.reshape(1), tok[:, None])
        done.logical_or_(tok == eos_id)
        embeds = llama.embed(params["llm"], tok[:, None])
        logits, _ = llama.decode_step(
            params["llm"], cfg.llm, embeds, spliced_len + step, prompt_cache,
            prompt_seg, gen_cache, step, attn_impl=attn_impl, tp=tp,
            tp_group=tp_group)
        cur.copy_(_select_token(logits, temperature, top_p, seed, step))
        step.add_(1)

    return state, [body]


def _decode_impl(
    params: Params,
    cfg: LlavaConfig,
    first_tok: torch.Tensor,
    spliced_len: torch.Tensor,
    prompt_cache: Params,
    prompt_seg: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    attn_impl: str = "auto",
    graph: Optional[bool] = None,
    loop_stats: Optional[dict] = None,
    temperature: float = 0.0,
    top_p: float = 1.0,
    seed: int = 0,
    tp: int = 1,
    tp_group=None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Decode loop: (tokens (B, max_new) int32, num_generated (B,), steps).
    Slots past the last step hold 0; tokens after a row's EOS are eos_id.
    `graph`, `loop_stats`, `group` (the process group the body's
    collectives run on): graph_loop.run_loop's `graph`, `stats` and
    `group`."""
    state, bodies = decode_loop(params, cfg, first_tok, spliced_len,
                                prompt_cache, prompt_seg, max_new_tokens,
                                eos_id, attn_impl, temperature, top_p, seed,
                                tp, tp_group)
    steps = graph_loop.run_loop(
        bodies, lambda: not bool(state.done.all()), max_new_tokens,
        first_tok.device, graph, loop_stats, group=group)
    tokens = state.tokens
    written = torch.arange(max_new_tokens, device=tokens.device)[None] < steps
    num = ((tokens != eos_id) & written).sum(dim=1).to(torch.int32)
    return tokens, num, steps


def generate(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,  # (B, S) right-padded, -200 image sentinel
    images: torch.Tensor,  # (B, 3, H, W)
    prompt_lengths: torch.Tensor,  # (B,) valid tokens before the splice
    max_new_tokens: int,
    eos_id: int,
    attn_impl: str = "auto",
    temperature: float = 0.0,
    top_p: float = 1.0,
    seed: int = 0,
    kv_quant=False,
    mesh=None,
    graph: Optional[bool] = None,
    loop_stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, max_new) int32, num_generated (B,)).

    temperature 0 is greedy (the reference's do_sample=temperature>0
    convention); otherwise nucleus sampling with `top_p`, the first token
    included, drawn from `seed` (the reference's `rng` key): the first
    token under the step key FIRST_STEP, each later one under its decode
    step. Rows stop at EOS; finished rows keep emitting eos_id. Rows with
    prompt length 0 are dead rows: they emit eos_id at once.

    kv_quant: False = bf16 prompt cache; True | "int8" = int8 values +
    per-(token, head) scales; "int4" = nibble-packed token pairs. The gen
    cache is int8 whenever the prompt cache is quantized. The decode loop
    runs from a CUDA graph on the card (`graph`, `loop_stats`:
    graph_loop.run_loop's `graph` and `stats`; under a gloo group whose
    collectives the loop runs, graph=None runs it eagerly).

    mesh (parallel/mesh.Mesh): every rank passes the whole batch, which
    must divide the data axis, and gets the whole batch's tokens back
    (module docstring). `params` is this rank's placement
    (partition.place_serving, once for many calls), or the whole tree,
    placed on every call."""
    if temperature < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"temperature must be >= 0 and top_p in (0, 1], "
                         f"got {temperature}, {top_p}")
    args = (cfg, input_ids, images, prompt_lengths, max_new_tokens, eos_id,
            attn_impl, temperature, top_p)
    if mesh is None:
        if isinstance(params, partition.Placed):
            raise ValueError("generate: placed shards need their mesh")
        partition.check_pack_stamp(params, False, None)
        return _generate_rows(params, *args, seed, kv_quant, graph,
                              loop_stats)
    placed = params if isinstance(params, partition.Placed) else (
        partition.place_serving(params, cfg, mesh))
    return _generate_shard(placed, mesh, *args, seed, kv_quant, graph,
                           loop_stats)


def _generate_rows(params, cfg, input_ids, images, prompt_lengths,
                   max_new_tokens, eos_id, attn_impl, temperature, top_p,
                   seed, kv_quant, graph, loop_stats, tp=1, tp_group=None,
                   group=None):
    """The single-device program on these rows (manual TP with tp /
    tp_group; `group`: the process group of the loop's collectives)."""
    first_tok, first_logits, spliced_len, prompt_cache, prompt_seg = (
        _prefill_impl(params, cfg, input_ids, images, prompt_lengths,
                      attn_impl, kv_quant, tp, tp_group))
    if temperature > 0.0:
        first_tok = _select_token(first_logits, temperature, top_p, seed,
                                  FIRST_STEP)
    tokens, num, _ = _decode_impl(
        params, cfg, first_tok, spliced_len, prompt_cache, prompt_seg,
        max_new_tokens, eos_id, attn_impl, graph, loop_stats, temperature,
        top_p, seed, tp, tp_group, group)
    return tokens, num


def shard_rows(mesh, *batch):
    """(rows of this rank's data index of each batch tensor, rows a
    shard); the rows must divide the data axis."""
    dp, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    if batch[0].shape[0] % dp:
        raise ValueError(f"batch {batch[0].shape[0]} must be a multiple of "
                         f"the mesh data axis size ({dp})")
    n = batch[0].shape[0] // dp
    return [t[d * n:(d + 1) * n] for t in batch], n


def gather_rows(mesh, *local):
    """Every data shard's rows, in order, on every rank (a data axis of one
    has them)."""
    if mesh.size(DATA_AXIS) == 1:
        return local
    group = mesh.group(DATA_AXIS)
    return tuple(all_gather(t, group) for t in local)


def _generate_shard(placed, mesh, cfg, input_ids, images, prompt_lengths,
                    max_new_tokens, eos_id, attn_impl, temperature, top_p,
                    seed, kv_quant, graph, loop_stats):
    """This rank's rows on its route, then every shard's tokens."""
    (ids, ims, lens), n = shard_rows(mesh, input_ids, images, prompt_lengths)
    tp, tp_group, group, params = 1, None, None, placed.params
    if placed.route == "manual_tp":
        tp = mesh.size(MODEL_AXIS)
        tp_group = group = mesh.group(MODEL_AXIS)
    elif placed.route == "gather":
        group = mesh.group(MODEL_AXIS)
        params = partition.gather_at_use(placed, group)
    tokens, num = _generate_rows(
        params, cfg, ids, ims, lens, max_new_tokens, eos_id, attn_impl,
        temperature, top_p, seed + mesh.index(DATA_AXIS) * n, kv_quant,
        graph, loop_stats, tp, tp_group, group)
    return gather_rows(mesh, tokens, num)


def generate_greedy(
    params: Params,
    cfg: LlavaConfig,
    input_ids: torch.Tensor,
    images: torch.Tensor,
    prompt_lengths: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    attn_impl: str = "auto",
    kv_quant=False,
    graph: Optional[bool] = None,
    loop_stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding (the HALVA eval default): `generate` at temperature
    0."""
    return generate(params, cfg, input_ids, images, prompt_lengths,
                    max_new_tokens, eos_id, attn_impl, kv_quant=kv_quant,
                    graph=graph, loop_stats=loop_stats)


def decode_tokens(tokens, num_generated, tokenizer, eos_id: int,
                  stop_strs=()):
    """Host-side detokenize + stop-string trim (the reference's
    KeywordsStoppingCriteria semantics)."""
    outs = []
    for row in np.asarray(tokens):
        ids = []
        for tid in row.tolist():
            if tid == eos_id:
                break
            ids.append(tid)
        text = tokenizer.decode(ids, skip_special_tokens=True)
        for sstr in stop_strs:
            idx = text.find(sstr)
            if idx != -1:
                text = text[:idx]
        outs.append(text.strip())
    return outs
