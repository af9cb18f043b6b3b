"""``torch.cuda.max_memory_allocated()`` over set-up and window, after the
peak was reset at the start of the process, in GiB."""


def read(run):
    return run.peak_bytes / 2**30
