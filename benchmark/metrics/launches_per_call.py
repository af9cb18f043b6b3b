"""Device kernels per call of the traced window, every kernel the card ran
(the program's own and PyTorch's), from the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    return run.trace.kernel_count / run.trace.calls
