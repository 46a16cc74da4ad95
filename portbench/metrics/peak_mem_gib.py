"""torch.cuda.max_memory_allocated over set-up and window, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2**30
