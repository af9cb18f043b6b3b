"""The whole call's share of the card's peak in the traced window, in %:
the least time the call's env steps take at the card's peaks (the bound
of its step kernel's work, read by the cell's ``roofline/work/`` reader)
over the call's mean time on the card's stream.  It bounds the kernel's
roofline share from below, whatever kernels a later program runs."""

from benchmark.roofline import counts, window


def read(run):
    work = window.work(run)
    if work is None or not run.window.call_ms:
        return None
    call_s = sum(run.window.call_ms) / 1e3
    return 100.0 * counts.bound_s(work[0], work[1])[0] / call_s
