"""DPA samples of every micro-step completed in the window, over the time
from the window's start to the last completion (host clock)."""


def read(rec):
    if rec["kind"] != "dpa_train":
        return None
    return sum(u["items"] for u in rec["units"]) / rec["window_s"]
