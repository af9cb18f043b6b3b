"""``ctf_steps``'s share of its roofline in the traced window, in %: the least
time its launches' bytes or operations take at the card's peaks
(``roofline/counts.py``), over their measured device time."""

from benchmark.roofline import window


def read(run):
    return window.share(window.work(run, "ctf_steps"))
