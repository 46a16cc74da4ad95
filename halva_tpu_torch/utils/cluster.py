"""Cluster lifecycle: preemption-aware checkpointing + wall-clock guard.

Parity with the reference's SLURM plumbing (SURVEY.md §5):
- AutoResume polling every N steps -> checkpoint + graceful stop
  (vila/train/callbacks/autoresume_callback.py:36-61);
- TimeoutTerminate: save and stop `pre_terminate_min` minutes before the
  job wall-clock limit (vila/train/slurm_utils.py:39-79).

Implemented as host-side callbacks the train loop polls; detection reads
SLURM env + an optional touch-file (works under any scheduler).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional


class PreemptionWatcher:
    """Checks for termination requests: SIGTERM, a sentinel file, or a
    user-supplied probe (e.g. SLURM AutoResume)."""

    def __init__(
        self,
        sentinel_path: Optional[str] = None,
        probe: Optional[Callable[[], bool]] = None,
        check_every: int = 50,
    ):
        self.sentinel_path = sentinel_path
        self.probe = probe
        self.check_every = check_every
        self._flag = False
        try:
            signal.signal(signal.SIGTERM, self._on_term)
        except ValueError:
            pass  # not the main thread

    def _on_term(self, signum, frame):
        self._flag = True

    def should_stop(self, step: int) -> bool:
        if self._flag:
            return True
        if step % self.check_every != 0:
            return False
        if self.sentinel_path and os.path.exists(self.sentinel_path):
            self._flag = True
        if self.probe is not None and self.probe():
            self._flag = True
        return self._flag


class WallClockGuard:
    """Stop `pre_terminate_min` minutes before `total_limit_min` elapses
    (reference Timer/TimeoutTerminateCallback semantics)."""

    def __init__(
        self,
        total_limit_min: Optional[float],
        pre_terminate_min: float = 10.0,
    ):
        self.start = time.time()
        self.total_limit_min = total_limit_min
        self.pre_terminate_min = pre_terminate_min

    @classmethod
    def from_env(cls) -> "WallClockGuard":
        """SLURM_JOB_END_TIME or HALVA_TIME_LIMIT_MIN if present."""
        end = os.environ.get("SLURM_JOB_END_TIME")
        if end:
            remaining_min = (float(end) - time.time()) / 60.0
            return cls(total_limit_min=remaining_min)
        lim = os.environ.get("HALVA_TIME_LIMIT_MIN")
        return cls(total_limit_min=float(lim) if lim else None)

    def elapsed_min(self) -> float:
        return (time.time() - self.start) / 60.0

    def should_stop(self) -> bool:
        if self.total_limit_min is None:
            return False
        return (
            self.elapsed_min()
            > self.total_limit_min - self.pre_terminate_min
        )
