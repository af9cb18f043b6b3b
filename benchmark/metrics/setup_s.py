"""Seconds from the run's first statement (the top of ``run.py``, just
after the interpreter's own start) to the window's start: imports, the
card, the kernels' build (the first run in a checkout) and load, the
states and weights made from the seed, and the warm-up calls."""


def read(run):
    return run.setup_s
