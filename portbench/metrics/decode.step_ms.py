"""A replayed decode step: (loop_s - capture_s - first_step_s) / (steps -
1) of each batch's loop_stats, the mean over the window's untraced
batches, in ms."""


def read(rec):
    if rec["kind"] != "eval_batches":
        return None
    vals = []
    for u in rec["units"]:
        s = u["loop"]
        if u["traced"] or s["steps"] < 2:
            continue
        vals.append((s["loop_s"] - s["capture_s"] - s["first_step_s"])
                    / (s["steps"] - 1))
    return 1e3 * sum(vals) / len(vals) if vals else None
