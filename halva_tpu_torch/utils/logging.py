"""Observability: rank-aware logging, step metrics, profiler hooks.

The reference scatters rank0_print (train_halva.py:29-31), wandb report_to,
file loggers (llava/utils.py:17-60) and no profiler at all; SURVEY.md §5
asks for first-class step timing + profiler hooks.

Counterpart of halva_tpu/utils/logging.py with the same names and the same
metrics JSONL: rank 0 of torch.distributed (when it is initialized) is the
main process, and the trace scope is torch.profiler's.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

_logger: Optional[logging.Logger] = None


def is_main_process() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def get_logger(name: str = "halva_tpu_torch") -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = logging.StreamHandler(sys.stdout)
            h.setFormatter(
                logging.Formatter(
                    "%(asctime)s %(levelname).1s %(name)s: %(message)s"
                )
            )
            logger.addHandler(h)
        logger.setLevel(logging.INFO)
        _logger = logger
    return _logger


def log0(msg: str, *args) -> None:
    """rank0_print equivalent."""
    if is_main_process():
        get_logger().info(msg, *args)


class MetricsLogger:
    """Append-only JSONL metrics (crash-tolerant, like the reference's
    flushed answers JSONL, model_vqa_loader.py:122-129)."""

    def __init__(self, path: Optional[str], report_to: str = "none"):
        self._f = None
        self._wandb = None
        if path and is_main_process():
            os.makedirs(
                os.path.dirname(os.path.abspath(path)), exist_ok=True
            )
            self._f = open(path, "a")
        if report_to == "wandb" and is_main_process():
            try:  # optional, like the reference's --report_to wandb
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "halva-tpu"),
                    resume="allow",
                )
            except Exception:
                get_logger().warning("wandb unavailable; JSONL only")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._wandb:
            self._wandb.log(
                {k: v for k, v in rec.items() if k != "time"}, step=step
            )
        log0(
            "step %d | %s",
            step,
            " ".join(
                f"{k}={rec[k]:.4g}" if isinstance(rec[k], float) else f"{k}={rec[k]}"
                for k in metrics
            ),
        )

    def close(self):
        if self._f:
            self._f.close()


class StepTimer:
    """EMA step timing + tokens/sec."""

    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._avg = None
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._avg = (
                dt
                if self._avg is None
                else self._ema * self._avg + (1 - self._ema) * dt
            )
        self._last = now
        return dt

    @property
    def avg(self) -> Optional[float]:
        return self._avg


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler scope over the CPU and, where there is one, the card;
    the trace is written to `logdir` as a Chrome trace (view in Perfetto or
    TensorBoard)."""
    if logdir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}.json"))
    else:
        yield
