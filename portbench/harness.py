"""What every traffic kind shares: the files found by name, the run's
context, the program's model made from the seed, and the result line.

A cell is `cells/<name>.json`, its configuration `configs/<name>.json`,
its traffic kind `traffic/<kind>.py` (a module with `run(ctx) -> record`),
each metric `metrics/<name>.py` (a reader `read(record) -> float | None`);
BENCHMARK.json at the checkout's root says which metrics a cell reports,
with their units.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that must not be loaded when a run prints its result
FORBIDDEN = ("jax", "jaxlib", "flax", "halva_tpu")
NOT_FINITE = 1e30


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    return load_json(os.path.join(HERE, "cells", f"{name}.json"))


def load_config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries this cell reports in a run of this kind."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # the run's start on the host clock

    @property
    def params(self) -> dict:
        return self.cell["traffic"]

    @property
    def model(self) -> dict:
        return self.config["model"]


def image_tokens(model: dict) -> int:
    """Patch tokens an image splices in (CLIP's patch features)."""
    v = model["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2


def port_config(config: dict):
    """The program's configuration object for this configuration file."""
    from halva_tpu_torch.config import llava_config_from_dict

    return llava_config_from_dict(config["model"])


def make_tree(ctx: Context):
    """(program config, weight tree on the device) from the seed."""
    import torch

    from halva_tpu_torch import tree as port_tree
    from portbench import weights

    cfg = port_config(ctx.config)
    shapes = port_tree.init_params(cfg, torch.Generator(), torch.bfloat16,
                                   "meta")
    return cfg, weights.make_weights(shapes, ctx.seed, ctx.device,
                                     getattr(torch, ctx.config["dtype"]))


def window_opens() -> None:
    """Before the window: the set-up's garbage collected, and every object
    alive now (the pre-made traffic, the weights' tree) left out of later
    collections, so that a collection in the window walks only what the
    window makes."""
    gc.collect()
    gc.freeze()


def window_closes() -> None:
    gc.unfreeze()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def device_info(ctx: Context, rec: dict) -> Dict[str, Any]:
    import torch

    dev = torch.device(ctx.device)
    info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": ctx.cell.get("chips", 1),
        "memory_peak_bytes": rec["peak_bytes"],
    }
    if ctx.trace:
        tr = rec.get("trace") or {}
        info["busy_s"] = tr.get("busy_s", 0.0)
        info["window_s"] = tr.get("window_s", 0.0)
    return info


def run_cell(cell_name: str, cell: dict, config: dict, seed: int,
             seconds: float, trace: bool, device: str,
             t0: Optional[float] = None, bench: Optional[dict] = None) -> dict:
    """One run of one cell: its record's metrics, checks and device, as
    the result line's dict (`checks` last)."""
    ctx = Context(cell_name, cell, config, seed, seconds, trace, device,
                  time.perf_counter() if t0 is None else t0)
    kind = importlib.import_module(f"portbench.traffic.{cell['traffic']['kind']}")
    rec = kind.run(ctx)
    bench = bench if bench is not None else benchmark()
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    out: Dict[str, Any] = {
        "correct": judge(rec["failed"], checks),
        "attempted": rec["attempted"],
        "failed": rec["failed"],
        "metrics": metrics,
        "device": device_info(ctx, rec),
    }
    if trace and rec.get("trace"):
        from portbench import trace as trace_lib

        out["breakdown"] = trace_lib.breakdown(rec["trace"])
    out["checks"] = checks
    return out


def check(value: float, limit: float) -> Dict[str, float]:
    """A compared number beside its limit; a number that is not finite
    reads as NOT_FINITE, which no limit admits."""
    v = float(value)
    return {"value": v if math.isfinite(v) else NOT_FINITE,
            "limit": float(limit)}


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """Every number the cell's limits name, beside its limit."""
    return {k: check(numbers[k], limit) for k, limit in limits.items()}


def judge(failed: int, checks: Dict[str, Dict[str, float]]) -> bool:
    """`correct`: nothing failed, and every compared number is within its
    limit."""
    return failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict[str, Dict[str, float]]) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)


def cache_dirs() -> None:
    """Every build and kernel cache the program or torch may write, at
    fixed paths inside the checkout (the kernel library already builds
    into build/kernels/ there)."""
    base = os.path.join(ROOT, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)
    os.environ.setdefault("USE_FLAX", "0")
