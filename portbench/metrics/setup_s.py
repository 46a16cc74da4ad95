"""Seconds from the process's start to the window's: imports, weights
made from the seed, the program's set-up, warm-up (and, in a checkout's
first run, the kernel build)."""


def read(rec):
    return rec["setup_s"]
