"""Mean milliseconds of ``train_step.rollout`` over the traced window's
train steps, between CUDA events on the card's stream around it."""


def read(run):
    ms = run.counts.get("rollout_ms")
    return sum(ms) / len(ms) if ms else None
