"""The readings that the limits of `correct` are set from.

    python3 -m portbench.control --workload <cell> --mode <mode> \
        --seeds <n>[,<n>...]

For each seed, in one process: the cell's weights and traffic from the
seed, the program's checked path at the cell's own size (a training cell's
first micro-steps; an eval cell's first `control_batches` batches), then
the same comparison with the plain reference that a run makes, held
against the cell's limits as a run holds them (`harness.checks`,
`harness.judge`). One JSON line a seed: {"seed", "mode", "correct",
"checks", "numbers", "readings"}: `checks` each compared number beside its
limit, `numbers` every number the comparison gives.

Modes:
- program: the program as the configuration states it (bf16), for the
  lower reading;
- int8: the control, the program's own lower-precision path: its int8
  tree (`ops/quant.quantize_params`, W8A8 on, the CLI's `--quant int8`);
- half (training cells): the fault "half of the batch left out": the
  program's step takes the first half of each micro-batch's rows, its
  loss the mean over them.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness

MODES = ("program", "int8", "half")


def halved(st: dict) -> None:
    step = st["step"]

    def train_step(tr, fr, rp, opt, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step(tr, fr, rp, opt, half)

    st["step"] = train_step


def readings(ctx, mode: str) -> dict:
    """What one seed gives under `mode`: `correct` and the compared
    numbers beside their limits, as a run's line has them, every number
    of the comparison, and its readings."""
    kind = ctx.cell["traffic"]["kind"]
    if kind == "dpa_train":
        from portbench.traffic import dpa_train as t

        st = t.prepare(ctx, quantize=mode == "int8")
        if mode == "half":
            halved(st)
        prog = t.first_steps(st, ctx.cell["job"])
        t.drop_program(st, ctx.device)
        nums = t.check(ctx, st, prog)
    elif kind == "eval_batches":
        if mode == "half":
            raise ValueError("the half-batch fault reading is for training "
                             "cells")
        from portbench.traffic import eval_batches as t

        st = t.prepare(ctx, quantize=mode == "int8")
        start = time.perf_counter()
        units = [t.unit(ctx, st, i, start, False)
                 for i in range(ctx.params["control_batches"])]
        st["served"] = None
        harness.free(ctx.device)
        nums = t.check(ctx, st, units)
    else:
        raise ValueError(f"no readings for the traffic kind {kind!r}")
    checks = harness.checks(nums, ctx.cell["limits"])
    out = {"correct": harness.judge(0, checks), "checks": checks,
           "numbers": nums, "readings": st["readings"]}
    del st
    harness.free(ctx.device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=MODES, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    config = harness.load_config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(args.workload, cell, config, seed, 0.0, False,
                              args.device, time.perf_counter())
        out = readings(ctx, args.mode)
        print(json.dumps({"seed": seed, "mode": args.mode, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
