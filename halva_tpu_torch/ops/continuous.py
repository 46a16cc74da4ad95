"""Continuous batching: rows freed by EOS or their budget refill from a
queue of pending requests.

Counterpart of halva_tpu/ops/continuous.py. The one-shot decode loop
(ops/generate.py) drains whole batches: it stops when every row is done, so
the longest caption gates the batch. Here the decode runs in chunks of at
most `chunk` steps, each a `graph_loop.run_loop` over one body that stops
early once every resident row is done. Between chunks the host reads the
(B,) done mask, harvests the finished rows' tokens and refills their slots.

- Rows run at per-row local steps over a ring-buffered gen cache. The KV
  write slot stays one scalar, global_step % Sg, and per-row validity is
  ring arithmetic (`_ring_valid`) handed to `llama.decode_step` as
  `gen_valid_override`; K4 reads it per slot. A slot s holds the KV of
  global step g(s) = G - ((G - s) mod Sg) and is valid for row r iff g(s)
  >= row_start[r]. A row writes for at most max_new <= Sg steps, so its own
  live tokens never collide, and a previous occupant's stale KV lies below
  row_start, unseen.
- A refill prefills an R-row bucket (R from `refill_sizes`, short queues
  padded with dead rows) eagerly through `generate._prefill_impl` and
  writes its rows into the resident state in place (`index_copy_`), so the
  body's CUDA graph, captured once per engine, stays valid across refills.
- Each row's `budget` bounds its emission: the synthetic workload's EOS
  and the max_new cap in one mechanism.

Greedy, RoPE, single device, as the reference; `decode_step` refuses the
ring mask on ALiBi and window configs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from halva_tpu_torch import tree
from halva_tpu_torch.config import LlavaConfig
from halva_tpu_torch.models import llama
from halva_tpu_torch.ops import graph_loop
from halva_tpu_torch.ops.generate import _prefill_impl, init_gen_cache_like

Params = Dict[str, Any]


class CBState(NamedTuple):
    """The engine's resident state, advanced and refilled in place."""
    global_step: torch.Tensor  # () int64 steps run so far
    row_start: torch.Tensor  # (B,) int64 global step of each row's first token
    base_len: torch.Tensor  # (B,) spliced prompt length
    cur: torch.Tensor  # (B,) int32 next token to emit
    done: torch.Tensor  # (B,) bool
    budget: torch.Tensor  # (B,) int32 max tokens for this row
    n_emitted: torch.Tensor  # (B,) int32 tokens written so far
    tokens: torch.Tensor  # (B, cap) int32 emissions at local steps
    prompt_cache: Params
    prompt_seg: torch.Tensor  # (B, Sp) int32
    gen_cache: Params


def _ring_valid(global_now: torch.Tensor, row_start: torch.Tensor,
                sg: int) -> torch.Tensor:
    """(B, Sg) gen validity after the write at slot global_now % Sg: slot s
    holds the KV of global step g(s) = G - ((G - s) mod Sg), valid iff that
    step lies in the row's current occupancy."""
    s = torch.arange(sg, device=row_start.device)[None, :]
    g = global_now - torch.remainder(global_now - s, sg)
    return g >= row_start[:, None]


def chunk_body(params: Params, cfg: LlavaConfig, st: CBState, eos_id: int,
               attn_impl: str = "auto"):
    """One lockstep step of every resident row, in place, reading nothing on
    the host: emit `cur` at the row's local step (nothing on done rows),
    count it, mark rows done at EOS or their budget, then `decode_step` at
    the row's own position with the ring mask and the write slot G % Sg,
    argmax, G + 1."""
    sg = st.gen_cache["k"].shape[3]
    cap = st.tokens.shape[1]

    def body():
        g = st.global_step
        live = ~st.done
        tok = torch.where(st.done, torch.full_like(st.cur, eos_id), st.cur)
        local = (g - st.row_start).clamp(0, cap - 1)[:, None]
        old = st.tokens.gather(1, local)
        st.tokens.scatter_(1, local, torch.where(live[:, None],
                                                 tok[:, None], old))
        st.n_emitted.add_(live.to(st.n_emitted.dtype))
        st.done.logical_or_((tok == eos_id) | (st.n_emitted >= st.budget))
        pos = st.base_len + (g - st.row_start)
        embeds = llama.embed(params["llm"], tok[:, None])
        logits, _ = llama.decode_step(
            params["llm"], cfg.llm, embeds, pos, st.prompt_cache,
            st.prompt_seg, st.gen_cache, g, attn_impl=attn_impl,
            gen_valid_override=_ring_valid(g, st.row_start, sg),
            write_slot=torch.remainder(g, sg))
        st.cur.copy_(logits.argmax(dim=-1))
        st.global_step.add_(1)

    return body


def _seq_pad(cache: Params, like: Params) -> Params:
    """Pad a refill's prompt cache up to the resident cache's dims, every
    dim but the batch dim (1): the refill keeps its R rows, the scatter
    writes them into their slots. Padded sequence slots stay masked by
    segment 0; scales pad with 1."""
    out = {}
    for k, v in cache.items():
        tgt = like[k].shape
        if v.ndim != len(tgt):
            raise ValueError(f"{k}: {tuple(v.shape)} against {tuple(tgt)}")
        widths = [t - s for s, t in zip(v.shape, tgt)]
        widths[1] = 0
        if any(w < 0 for w in widths):
            raise ValueError(f"{k}: {tuple(v.shape)} exceeds {tuple(tgt)}")
        if any(widths):
            pad = []
            for w in reversed(widths):
                pad += [0, w]
            v = torch.nn.functional.pad(
                v, pad, value=1 if k.endswith("_scale") else 0)
        out[k] = v
    return out


class Request(NamedTuple):
    ids: np.ndarray  # (S,) prompt token ids, unpadded
    image: Any  # (3, H, W) array, or a callable that returns one
    budget: int  # max new tokens for this row


class ContinuousEngine:
    """Host orchestrator: a resident B-row state and a pending queue.

    run(requests) returns (tokens (cap,), n_emitted) per request, in request
    order; each row's tokens are those of a one-shot greedy decode of that
    prompt with the same budget (tests/test_torch_continuous.py). `graph`:
    graph_loop.run_loop's (None: CUDA graphs on the card, eager on the
    CPU). stats: "chunks", "refills", "steps" (lockstep steps run)."""

    REFILL_FRACS = (1.0, 0.5, 0.25, 0.125)

    def __init__(
        self,
        params: Params,
        cfg: LlavaConfig,
        batch: int,
        max_new_tokens: int,
        eos_id: int,
        prompt_pad: int,
        chunk: int = 16,
        kv_quant=False,
        attn_impl: str = "auto",
        max_refill: Optional[int] = None,
        graph: Optional[bool] = None,
    ):
        if batch % 8:
            raise ValueError("batch must divide into refill buckets of 8")
        self.params, self.cfg = params, cfg
        self.b, self.cap = batch, max_new_tokens
        self.eos, self.chunk = eos_id, chunk
        self.kv_quant, self.attn_impl = kv_quant, attn_impl
        self.prompt_pad = prompt_pad
        self.graph = graph
        # the refill bucket cap: an R-row refill's prompt cache is
        # co-resident with the whole engine state while it is written in
        if max_refill is None:
            max_refill = int(os.environ.get("HALVA_CB_REFILL", "16"))
        self.refill_sizes = sorted(
            {max(8, min(max_refill, int(batch * f)))
             for f in self.REFILL_FRACS}, reverse=True)
        # any tensor leaf: a quantized tree has embedding_q, not embedding
        self.device = next(t for _, t in tree.flatten(params["llm"])
                           if isinstance(t, torch.Tensor)).device
        self.state: Optional[CBState] = None  # made at the first refill
        self._body = None
        self._graphs = graph_loop.LoopGraphs()
        self.stats = {"chunks": 0, "refills": 0, "steps": 0}

    def _make_state(self, pc: Params, seg: torch.Tensor) -> CBState:
        """The resident state, shaped after the first refill's prompt cache
        (the reference's eval_shape of a full-batch prefill): every row
        dead."""
        b, dev = self.b, self.device

        def zeros_like_rows(t):
            return torch.zeros((t.shape[0], b) + tuple(t.shape[2:]),
                               dtype=t.dtype, device=dev)

        long = dict(dtype=torch.long, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        prompt_cache = {k: zeros_like_rows(v) for k, v in pc.items()}
        return CBState(
            global_step=torch.zeros((), **long),
            row_start=torch.zeros((b,), **long),
            base_len=torch.zeros((b,), **i32),
            cur=torch.full((b,), self.eos, **i32),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            budget=torch.zeros((b,), **i32),
            n_emitted=torch.zeros((b,), **i32),
            tokens=torch.zeros((b, self.cap), **i32),
            prompt_cache=prompt_cache,
            prompt_seg=torch.zeros((b, seg.shape[1]), **i32),
            gen_cache=init_gen_cache_like(self.cfg.llm, b, self.cap,
                                          prompt_cache))

    def _prefill(self, reqs: List[Request], r: int):
        """Prefill an r-row bucket (dead rows pad it): (prompt cache, seg,
        first tokens, spliced lengths, budgets) on the device."""
        s = self.prompt_pad
        size = self.cfg.vision.image_size
        ids = np.zeros((r, s), np.int32)
        lens = np.zeros((r,), np.int32)
        imgs = np.zeros((r, 3, size, size), np.float32)
        budget = np.zeros((r,), np.int32)
        for i, rq in enumerate(reqs):
            n = min(len(rq.ids), s)
            ids[i, :n] = rq.ids[:n]
            lens[i] = n
            # lazy images: the runner hands callables backed by a prefetch
            # pool, so image decode overlaps the device
            imgs[i] = rq.image() if callable(rq.image) else rq.image
            budget[i] = min(rq.budget, self.cap)
        dev = self.device
        ft, _, sl, pc, seg = _prefill_impl(
            self.params, self.cfg, torch.from_numpy(ids).to(dev),
            torch.from_numpy(imgs).to(dev), torch.from_numpy(lens).to(dev),
            self.attn_impl, self.kv_quant)
        return pc, seg, ft, sl, torch.from_numpy(budget).to(dev)

    def _scatter(self, slots: List[int], pc, seg, ft, sl, budget) -> None:
        """Write an R-row prefill into state rows `slots`, in place."""
        if self.state is None:
            self.state = self._make_state(pc, seg)
        st = self.state
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        for k, v in _seq_pad(pc, st.prompt_cache).items():
            st.prompt_cache[k].index_copy_(1, idx, v)
        dead = sl == 0
        st.row_start.index_copy_(0, idx, st.global_step.expand(len(slots)))
        st.base_len.index_copy_(0, idx, sl.to(st.base_len.dtype))
        st.cur.index_copy_(0, idx, ft.to(st.cur.dtype))
        st.done.index_copy_(0, idx, dead)
        st.budget.index_copy_(0, idx, torch.where(
            dead, torch.zeros_like(budget), budget))
        st.n_emitted.index_fill_(0, idx, 0)
        st.tokens.index_fill_(0, idx, 0)
        st.prompt_seg.index_copy_(0, idx, seg.to(st.prompt_seg.dtype))

    def _run_chunk(self) -> int:
        st = self.state
        if self._body is None:
            self._body = chunk_body(self.params, self.cfg, st, self.eos,
                                    self.attn_impl)
        return graph_loop.run_loop(
            [self._body], lambda: not bool(st.done.all()), self.chunk,
            self.device, self.graph, keep=self._graphs)

    def run(self, requests: Sequence[Request]
            ) -> List[Optional[Tuple[np.ndarray, int]]]:
        results: List[Optional[Tuple[np.ndarray, int]]] = (
            [None] * len(requests))
        pending = list(range(len(requests)))
        pending.reverse()  # pop() serves request order
        occupant = [-1] * self.b  # request index per slot
        free = list(range(self.b))
        while pending or any(o >= 0 for o in occupant):
            # refill: the largest bucket that fits the free slots; pad the
            # bucket with dead rows when the queue runs short
            while free and pending:
                r = next((n for n in self.refill_sizes
                          if n <= len(free)
                          and (len(pending) >= n
                               or n == min(self.refill_sizes))), None)
                if r is None:
                    break
                take = [pending.pop() for _ in range(min(r, len(pending)))]
                slots = [free.pop() for _ in range(r)]
                self._scatter(slots, *self._prefill(
                    [requests[i] for i in take], r))
                for j, req_i in enumerate(take):
                    occupant[slots[j]] = req_i
                # bucket-padding rows stay dead; release their slots
                free.extend(slots[len(take):])
                self.stats["refills"] += 1
            if all(o < 0 for o in occupant):
                break
            self.stats["steps"] += self._run_chunk()
            self.stats["chunks"] += 1
            st = self.state
            done = st.done.cpu().numpy()
            n_em = st.n_emitted.cpu().numpy()
            toks = None
            for slot in range(self.b):
                if occupant[slot] >= 0 and done[slot]:
                    if toks is None:
                        toks = st.tokens.cpu().numpy()
                    results[occupant[slot]] = (toks[slot].copy(),
                                               int(n_em[slot]))
                    occupant[slot] = -1
                    free.append(slot)
        return results

