"""One run of one benchmark cell of halva_tpu_torch on the H100.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It makes the cell's weights and traffic from the seed, warms up, runs the
measured window for `--seconds`, checks what the window produced against
the plain reference, and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and `checks`, each compared number beside its
limit (also the last lines on standard error). Without as many CUDA
devices as the cell asks for it exits 2 and prints no result; with a JAX
module loaded at the end it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T0 = time.perf_counter()


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from portbench import harness

    args = parse(argv)
    if args.seed < 0:
        print("portbench: --seed must be a whole number >= 0",
              file=sys.stderr)
        return 2
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)  # one process, few threads: steadier runs
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {found}; no result", file=sys.stderr)
        return 2
    config = harness.load_config(cell["config"])
    out = harness.run_cell(args.workload, cell, config, args.seed,
                           args.seconds, bool(args.trace), "cuda", t0=T0)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"portbench: modules loaded that no run may load: {leaked}; "
              "no result", file=sys.stderr)
        return 3
    harness.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
