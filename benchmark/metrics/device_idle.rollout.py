"""The card's idle share of the traced window, in %: 100 (1 - the device
operations' summed seconds / the window's wall seconds)."""


def read(run):
    if run.trace is None or run.trace.summed_s == 0:
        return None
    return 100.0 * (1.0 - run.trace.summed_s / run.trace.window_s)
