"""K1, K2 and K3 (flash forward and backward) in the traced micro-steps:
the sum of their bounds (flops.py, live rows) over their device time, in
%."""

from portbench import flops
from portbench.roofline import share

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def work(shapes, rec):
    """Per layer: K1 in the policy forward of the pos/neg rows and of the
    reference rows, again in each under remat, and in the frozen forward of
    the reference rows; K2 and K3 in the backward of each policy forward."""
    llm = rec["model"]["llm"]
    h, kvh, d, window = flops.attn_dims(llm)
    again = 1 if rec["job"]["remat"] else 0
    bound, calls = 0.0, 0
    for lens, s_pad, fwd in ((shapes["pn"], shapes["pn_pad"], 1 + again),
                             (shapes["ref"], shapes["ref_pad"], 2 + again)):
        bound += fwd * flops.bound_s(*flops.flash_fwd(lens, s_pad, h, kvh, d,
                                                      window))
        bound += flops.bound_s(*flops.flash_bwd_dq(lens, s_pad, h, kvh, d,
                                                   window))
        bound += flops.bound_s(*flops.flash_bwd_dkv(lens, s_pad, h, kvh, d,
                                                    window))
        calls += fwd + 2
    layers = llm["num_layers"]
    return layers * bound, layers * calls


def read(rec):
    return share(rec, KERNELS, work) if rec["kind"] == "dpa_train" else None
