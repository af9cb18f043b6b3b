"""Agents x envs x steps of every call completed in the window, over the
window's host seconds (from its start to the synchronise after its last
call)."""


def read(run):
    if "agent_steps" not in run.work:
        return None
    return run.window.calls * run.work["agent_steps"] / run.window.seconds
