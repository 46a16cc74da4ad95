"""Model FLOPs of the window's batches (flops.eval_batch_flops: tower,
projector, prefill, the decode steps each row needs) over their time and
the H100's bf16 peak, in %; traced batches left out."""

from portbench.flops import PEAK_BF16_FLOP_S


def read(rec):
    if rec["kind"] != "eval_batches":
        return None
    units = [u for u in rec["units"] if not u["traced"]]
    t = sum(u["t"] for u in units)
    if not t:
        return None
    return 100 * sum(u["flops"] for u in units) / t / PEAK_BF16_FLOP_S
