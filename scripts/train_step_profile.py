#!/usr/bin/env python3
"""The DPA LoRA train micro-step of each 7B family, on the host clock and
under torch.profiler, with the attention backward's share of its device
time.

    python3 scripts/train_step_profile.py [llava] [mistral] [mpt]

For llava-v1.5-7b, Mistral-7B and MPT-7B under CLIP ViT-L/14-336 (random
bf16 trees from seed 0; chip_smoke.py's train recipe: LoRA r=128 on every
LLM linear, remat, loss_chunk=256, AdamW, micro-batch 2 of 1087 spliced
tokens) it runs 4 micro-steps and prints their host-clock times, then one
more under torch.profiler and prints the device time of its kernels, that
of the attention backward (K2's and K3's kernels by name, and the torch
kernels of the delta pass, flash_attention_delta, under a profiler range
of their own: the profiler does not attribute kernels launched through
ctypes to a range) with its share, and K2's and K3's own. It imports
halva_tpu_torch and chip_smoke.py from the directory it is run in, so that
two trees are compared by running it from each in turn on one card:

    (cd build/parent && python3 ../../scripts/train_step_profile.py)

Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from halva_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from halva_tpu_torch.train.lora import add_lora  # noqa: E402
from halva_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig,
    dpa_step_fns,
    init_train_state,
)

FAMILIES = {
    "llava": (cs.LLAVA_V15_7B, "llava-v1.5-7b"),
    "mistral": (cs.LLAVA_MISTRAL_7B, "llava-mistral-7b"),
    "mpt": (cs.LLAVA_MPT_7B, "llava-mpt-7b"),
}
TIMED_STEPS = 4  # the first is a warm-up
RANGE = "attention backward delta"


def device_times(prof):
    """(all kernels, the delta pass's range, K2, K3) in ms."""
    from torch.autograd import DeviceType

    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    k2 = sum(e.self_device_time_total for e in kernels
             if "flash_bwd_dq" in e.name)
    k3 = sum(e.self_device_time_total for e in kernels
             if "flash_bwd_dkv" in e.name)
    delta = sum(e.device_time_total for e in events
                if e.name == RANGE and e.device_type == DeviceType.CPU)
    return total / 1e3, delta / 1e3, k2 / 1e3, k3 / 1e3


def run(family: str) -> None:
    cfg, name = FAMILIES[family]
    params = cs.new_tree(cfg, name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    policy = add_lora(params, gen, rank=128, alpha=256.0)
    tcfg = TrainConfig(grad_accum_steps=2, num_train_steps=400, remat=True,
                       loss_chunk=256)
    trainable, frozen, opt, opt_state = init_train_state(policy, tcfg)
    step, _ = dpa_step_fns(cfg, tcfg, opt)
    batches = [cs.train_batch(cfg, seed) for seed in range(TIMED_STEPS + 1)]
    times = []
    for batch in batches[:TIMED_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainable, opt_state, _ = step(trainable, frozen, None, opt_state,
                                       batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    inner = flash_ops.flash_attention_delta

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(RANGE):
            return inner(*args, **kwargs)

    flash_ops.flash_attention_delta = annotated
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(trainable, frozen, None, opt_state, batches[-1])
            torch.cuda.synchronize()
    finally:
        flash_ops.flash_attention_delta = inner
    total, delta, k2, k3 = device_times(prof)
    bwd = k2 + k3 + delta
    print(f"{name} train micro-step ({cs.gpu_line()}): host clock "
          f"{statistics.mean(times[1:]):.1f} ms (mean of micro-steps 1-"
          f"{TIMED_STEPS - 1}; all: "
          + ", ".join(f"{t:.1f}" for t in times)
          + f" ms); profiled micro-step: kernels {total:.1f} ms of device "
          f"time, attention backward (K2, K3, delta) {bwd:.2f} ms = "
          f"{100 * bwd / total:.2f} %: K2 {k2:.2f} ms, K3 {k3:.2f} ms, "
          f"delta {delta:.2f} ms",
          flush=True)
    del params, policy, trainable, frozen, opt, opt_state, step, prof
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("train_step_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    families = sys.argv[1:] or list(FAMILIES)
    for family in families:
        if family not in FAMILIES:
            raise SystemExit(f"train_step_profile: unknown family {family}; "
                             f"one of {sorted(FAMILIES)}")
    for family in families:
        run(family)


if __name__ == "__main__":
    main()
