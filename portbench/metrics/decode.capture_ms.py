"""The decode loop's CUDA-graph capture per batch (loop_stats capture_s),
the mean over the window's untraced batches, in ms."""


def read(rec):
    if rec["kind"] != "eval_batches":
        return None
    vals = [u["loop"]["capture_s"] for u in rec["units"] if not u["traced"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
