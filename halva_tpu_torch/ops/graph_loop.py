"""A decode loop's body, run once a step: replayed from a CUDA graph on the
card, eagerly on the CPU.

The reference compiles each decode loop (greedy, beams, speculative verify)
into one XLA program: a `lax.while_loop` whose `body` advances a state of
fixed-shape arrays and whose `cond` tests the budget and `done`
(halva_tpu/ops/generate.py:288-319, ops/beam.py:240,
ops/speculative.py:137-224). Here a body is a Python function that advances
a state of fixed-shape device tensors in place, the step included (a 0-d
tensor). On the card the first step runs eagerly, off the default stream:
it builds the kernel library, the split reductions' tickets and any table
that a capture cannot make. The body is then captured once into a
`torch.cuda.CUDAGraph` and replayed for every later step, so that a step
costs one host call instead of the few hundred launches of its Python
wrappers. The stop test stays on the host, one read of `done` a step, as
the reference's `cond`.

On the CPU the same body runs eagerly. That choice comes from the device,
never from a failure: a capture that fails raises.

A body may run collectives (a mesh's decode: parallel/mesh.py). NCCL's are
captured into the graph with the rest; gloo's cannot be, so a loop whose
`group` is a gloo group runs eagerly under graph=None and refuses
graph=True: it never drops a capture it was asked for.

A capture may outlive one loop: the continuous-batching engine
(ops/continuous.py) runs its chunks as loops over one body, and refills
rows between them by writing into the captured state in place. It passes
one `LoopGraphs` to every `run_loop` call: the first call captures into
it, and every later call replays from its first step.

Launch counts: a kernel's wrapper adds one to `_kernels.launches` where it
launches, which under a graph happens once, at capture, when nothing runs.
`StepGraph` takes the counts recorded at its capture back out and adds them
again at every replay, so the counts say what the loop launched.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from halva_tpu_torch import _kernels


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device for the eager first steps: cuBLAS keeps a
    workspace for every stream it runs on."""
    return torch.cuda.Stream(device)


class StepGraph:
    """One loop body captured into a CUDA graph. Capturing launches
    nothing: the state the body reads and writes must exist before, and is
    left as it was."""

    def __init__(self, body: Callable[[], None], pool=None):
        before = dict(_kernels.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            body()
        self.launches: Dict[str, int] = {
            name: n - before.get(name, 0)
            for name, n in _kernels.launches.items()
            if n != before.get(name, 0)}
        for name, n in self.launches.items():
            left = _kernels.launches[name] - n
            if left:
                _kernels.launches[name] = left
            else:
                del _kernels.launches[name]

    def replay(self) -> None:
        self.graph.replay()
        _kernels.launches.update(self.launches)


class LoopGraphs:
    """The graphs of a loop's bodies, kept across `run_loop` calls over the
    same bodies and the same state tensors."""

    def __init__(self):
        self.graphs = None


def run_loop(
    bodies: Sequence[Callable[[], None]],
    more: Callable[[], bool],
    max_steps: int,
    device: torch.device,
    graph: Optional[bool] = None,
    stats: Optional[dict] = None,
    keep: Optional[LoopGraphs] = None,
    group=None,
) -> int:
    """Run step n = 0, 1, ... with `bodies[n % len(bodies)]` while n <
    max_steps and `more()`; return the number of steps. Several bodies take
    turns where the state alternates between buffers (the beam loop's two
    gen caches); each gets its own graph, all in one memory pool.

    graph=None: replay from CUDA graphs on the card, eager on the CPU;
    graph=False: eager on either device (the reference a graph loop is held
    against). `stats`, when given, receives "steps", "graph", and host
    seconds: "capture_s" spent capturing, "first_step_s" until the stop
    test after the first step returned (the eager step, done on the device;
    0 without such a test), and
    "loop_s" for the whole loop, its device work included (the card is
    synchronized at the end). `keep`: the graphs captured by an earlier call
    over these bodies, replayed from step 0, or filled by this call.
    `group`: the process group whose collectives the bodies run, if any;
    a gloo group of more than one rank cannot be captured."""
    device = torch.device(device)
    if (group is not None and dist.get_world_size(group) > 1
            and dist.get_backend(group) == "gloo"):
        if graph:
            raise ValueError("a CUDA graph cannot capture gloo collectives: "
                             "run the loop with graph=None or False, or "
                             "over NCCL")
        graph = False
    use_graph = device.type == "cuda" if graph is None else graph
    if use_graph and device.type != "cuda":
        raise ValueError("a CUDA graph loop needs its state on the card, "
                         f"not on {device}")
    graphs = keep.graphs if keep is not None else None
    capture_s = first_step_s = 0.0
    t0 = time.perf_counter()
    n = 0
    while n < max_steps:
        go = more()
        if n == 1:
            first_step_s = time.perf_counter() - t0
        if not go:
            break
        k = n % len(bodies)
        if not use_graph:
            bodies[k]()
        elif n == 0 and graphs is None:
            side = _side_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                bodies[k]()
            torch.cuda.current_stream(device).wait_stream(side)
        else:
            if graphs is None:
                tc = time.perf_counter()
                pool = torch.cuda.graph_pool_handle()
                graphs = [StepGraph(b, pool) for b in bodies]
                capture_s = time.perf_counter() - tc
                if keep is not None:
                    keep.graphs = graphs
            graphs[k].replay()
        n += 1
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.update(steps=n, graph=use_graph, capture_s=capture_s,
                     first_step_s=first_step_s,
                     loop_s=time.perf_counter() - t0)
    return n
