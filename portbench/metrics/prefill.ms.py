"""Per batch, its wall time less the decode loop after its first step
(loop_s - first_step_s of generate's loop_stats): the input copies, the
tower, projector and prefill, the eager first step and the tokens' copy
out; the mean over the window's untraced batches, in ms."""


def read(rec):
    if rec["kind"] != "eval_batches":
        return None
    vals = [u["t"] - (u["loop"]["loop_s"] - u["loop"]["first_step_s"])
            for u in rec["units"] if not u["traced"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
