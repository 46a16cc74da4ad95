"""K1 (flash forward) in the traced batches' prefill: the sum of its
bounds (flops.py, live rows) over its device time, in %."""

from portbench import flops
from portbench.roofline import share

KERNELS = ("flash_fwd_kernel",)


def work(shapes, rec):
    """One K1 call a layer over the batch's prompts."""
    llm = rec["model"]["llm"]
    h, kvh, d, window = flops.attn_dims(llm)
    layers = llm["num_layers"]
    return layers * flops.bound_s(*flops.flash_fwd(
        shapes["prefill"], shapes["s_pad"], h, kvh, d, window)), layers


def read(rec):
    return share(rec, KERNELS, work) if rec["kind"] == "eval_batches" \
        else None
