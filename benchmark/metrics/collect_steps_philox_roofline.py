"""``collect_steps_philox``'s share of its roofline in the traced window, in
%: the least time its launches' bytes or operations take at the card's
peaks (``roofline/work/episode.collect.py``), over their measured device
time."""

from benchmark.roofline import window


def read(run):
    return window.share(window.work(run, "collect_steps_philox"))
