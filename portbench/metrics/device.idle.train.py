"""The device's idle share over the traced micro-steps: 1 - busy / span,
in %."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "dpa_train" or not tr or not tr["window_s"]:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
