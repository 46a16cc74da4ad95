"""The median window micro-step on the host clock, from the call to the
loss on the host; traced micro-steps left out."""

import statistics


def read(rec):
    if rec["kind"] != "dpa_train":
        return None
    times = [u["t"] for u in rec["units"] if not u["traced"]]
    return 1e3 * statistics.median(times) if times else None
