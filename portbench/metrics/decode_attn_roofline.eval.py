"""K4 (decode attention) in the traced batches' decode steps: the sum of
its bounds (flops.py, live rows) over its device time, in %."""

from portbench import flops
from portbench.roofline import share

KERNELS = ("decode_attn_kernel",)


def work(shapes, rec):
    """One K4 call a layer and step, step t reading the prompts and t + 1
    generated tokens; None where the decode path takes no K4."""
    if not shapes["decode_kernel"]:
        return None
    llm = rec["model"]["llm"]
    h, kvh, d, _ = flops.attn_dims(llm)
    layers, steps = llm["num_layers"], shapes["steps"]
    bound = sum(flops.bound_s(*flops.decode_attn(shapes["prefill"], t + 1, h,
                                                 kvh, d))
                for t in range(steps))
    return layers * bound, layers * steps


def read(rec):
    return share(rec, KERNELS, work) if rec["kind"] == "eval_batches" \
        else None
