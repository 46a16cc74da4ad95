"""Model FLOPs of the window's micro-steps (flops.train_step_flops) over
their time and the H100's bf16 peak, in %; traced micro-steps left out."""

from portbench.flops import PEAK_BF16_FLOP_S


def read(rec):
    if rec["kind"] != "dpa_train":
        return None
    units = [u for u in rec["units"] if not u["traced"]]
    t = sum(u["t"] for u in units)
    if not t:
        return None
    return 100 * sum(u["flops"] for u in units) / t / PEAK_BF16_FLOP_S
