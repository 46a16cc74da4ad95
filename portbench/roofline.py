"""A kernel's share of its roofline over a run's traced units: the sum of
the bounds of its launches over the sum of their device times in the
trace, in %.

A roofline metric's reader (metrics/<name>.py) brings what is its own: the
patterns of its kernels' device-function names, and its work model, a
function of one unit's recorded `shapes` and the run's record that gives
(bound seconds, launches) of the unit, or None where the unit holds none
of its work. The traffic kinds record each unit's shapes and nothing of
any kernel."""

from portbench import trace as trace_lib


def share(rec: dict, kernels, work):
    """None where the trace holds no launch of `kernels`, a traced unit
    none of their work, or the launches differ from what the work model
    counts (the path changed)."""
    tr = rec.get("trace")
    units = [u for u in rec["units"] if u["traced"]]
    if not tr or not units:
        return None
    found = [work(u["shapes"], rec) for u in units]
    if any(w is None for w in found):
        return None
    secs = launches = 0
    for name in kernels:
        t, n = trace_lib.kernel_time(tr, name)
        secs += t
        launches += n
    if not launches or launches != sum(w[1] for w in found):
        return None
    return 100 * sum(w[0] for w in found) / secs
