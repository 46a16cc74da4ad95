"""The device trace of a traced run, reduced to what the readers need.

`Tracer` runs some units of a run's loop under torch.profiler with CUDA
activity only (the device's operations and the CUDA calls the host makes,
as CUPTI records them; no per-operator host events, whose cost would make
the host, not the device, the bottleneck of the traced units), after one
more unit that warms the profiler up and is not kept. `reduce()` takes the
raw events to:

- `kernels`: device time and count of every device operation by name;
- `busy_s`: the union of the device operations' intervals;
- `window_s`: the traced units' time on the host clock (each ends with the
  host reading its result, so the device is done with it);
- `gaps`: the device's idle time by what the host was doing meanwhile: the
  innermost CUDA call open at a gap's start, "host, outside CUDA calls"
  where none was, and the idle time before each unit's first and after
  its last device operation under one name.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SHORT_NS = 5000
SHORT = "gaps under 5 us between device operations"
HOST = "host, outside CUDA calls"
EDGES = "before or after the device operations of a unit"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _short(name: str) -> str:
    """A device function's name without its return type and arguments."""
    if name.startswith("void "):
        name = name[5:]
    head = ""
    if name.startswith("(anonymous namespace)::"):
        head, name = "(anonymous namespace)::", name[23:]
    return (head + name.split("(")[0].strip())[:120]


def _annotation(ev, name: str) -> bool:
    """A range the profiler or a caller marked, not device work."""
    flag = getattr(ev, "is_user_annotation", None)
    return name.startswith("ProfilerStep") or bool(flag and flag())


class Tracer:
    """Profiles units `first` .. `first + active - 1` of a run's loop, after
    one more unit that warms the profiler up; `trace` then holds the
    reduced trace."""

    def __init__(self, first: int, active: int):
        self.first, self.active = first, active
        self.last = first + active - 1
        self.prof = None
        self.trace = None
        self.window_s = 0.0

    def traced(self, i: int) -> bool:
        return self.first <= i <= self.last

    @contextlib.contextmanager
    def unit(self, i: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        if i == self.first - 1:
            # a CPU-only build (the tests' runs) has no CUDA activity
            self.prof = profile(
                activities=[ProfilerActivity.CUDA
                            if torch.cuda.is_available()
                            else ProfilerActivity.CPU],
                schedule=schedule(wait=0, warmup=1, active=self.active,
                                  repeat=1),
                on_trace_ready=self._ready)
            self.prof.__enter__()
        t0 = time.perf_counter()
        yield
        if self.traced(i):
            self.window_s += time.perf_counter() - t0
        if self.prof is not None and self.first - 1 <= i <= self.last:
            self.prof.step()
            if i == self.last:
                self.prof.__exit__(None, None, None)
                self.prof = None

    def _ready(self, prof) -> None:
        self.trace = reduce(prof.profiler.kineto_results.events(),
                            self.window_s)


def reduce(events, window_s: float) -> dict:
    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for ev in events:
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if _annotation(ev, name):
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((start, end, name))
        else:
            host.append((start, end, name))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name in device:
        k = kernels[_short(name)]
        k[0] += (e - s) / 1e9
        k[1] += 1
    device.sort()
    busy = 0
    gaps: List[Tuple[int, int]] = []
    if device:
        cur_s, cur_e = device[0][0], device[0][1]
        for s, e, _ in device[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    busy_s = busy / 1e9
    attributed = _attribute(gaps, host)
    edges = window_s - busy_s - sum(attributed.values())
    if edges > 0:
        attributed[EDGES] = edges
    return {"kernels": {k: tuple(v) for k, v in kernels.items()},
            "busy_s": busy_s, "window_s": window_s, "gaps": attributed}


def _attribute(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's start;
    gaps under SHORT_NS between device operations are summed under one
    name."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_NS:
            out[SHORT] += (g1 - g0) / 1e9
            continue
        i = bisect.bisect_right(starts, g0)
        best = None
        for j in range(i - 1, max(-1, i - 200), -1):
            s, e, name = host[j]
            if e >= g0 and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        out[best[2] if best else HOST] += (g1 - g0) / 1e9
    return dict(out)


def kernel_time(trace: dict, pattern: str) -> Tuple[float, int]:
    """(device seconds, launches) of the device operations whose name
    holds `pattern`."""
    secs = n = 0
    for name, (t, c) in trace["kernels"].items():
        if pattern in name:
            secs += t
            n += c
    return secs, n


def breakdown(trace: dict, top: int = 10) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(trace["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, t] for name, (t, _) in ops],
            "idle_gaps": [[name, t] for name, t in gaps]}
