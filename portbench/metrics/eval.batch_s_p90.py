"""The 90th percentile of the window's untraced batches' wall times: copy
in, generate, tokens to the host (host clock). A batch stalled by the
host lands past the body of the rest, so this reads the body's edge or
the stalls depending on how many stalls a window holds."""

import statistics


def read(rec):
    if rec["kind"] != "eval_batches":
        return None
    times = [u["t"] for u in rec["units"] if not u["traced"]]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[8]
