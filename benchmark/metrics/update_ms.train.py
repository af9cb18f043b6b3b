"""Mean milliseconds of ``train_step.update`` over the traced window's
train steps, between CUDA events on the card's stream around it."""


def read(run):
    ms = run.counts.get("update_ms")
    return sum(ms) / len(ms) if ms else None
