"""Envs x rollout_len x train steps completed in a traced run's window
before the profiler (``untraced_window_in_trace``), over that window's
host seconds.  The learner is paced by the host (its 165 host
synchronisations a step), so this rate moves with the host's speed from
run to run by more than an end-to-end bound can hold; it is read per
layer, with no bound."""


def read(run):
    win = run.untraced
    if win is None or "env_steps" not in run.work:
        return None
    return win.calls * run.work["env_steps"] / win.seconds
