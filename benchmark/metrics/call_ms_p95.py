"""The 95th percentile over every call of the window of the call's time on
the card's stream: from the event recorded after the call before (or at
the window's start) to the event recorded after it."""

from benchmark.harness import p95


def read(run):
    return p95(run.window.call_ms)
