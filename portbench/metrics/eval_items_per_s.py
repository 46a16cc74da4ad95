"""Requests (questions or captions) of every batch completed in the
window, over the time from the window's start to the last completion (host
clock)."""


def read(rec):
    if rec["kind"] != "eval_batches":
        return None
    return sum(u["items"] for u in rec["units"]) / rec["window_s"]
