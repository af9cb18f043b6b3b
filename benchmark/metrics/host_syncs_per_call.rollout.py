"""Host synchronisations a call of the episode rollout: the CUDA runtime
calls that make the host wait for the card (:data:`SYNCS`) whose start
lies inside a ``rollout.call`` span, over the window's calls.  The
rollouts say nothing in their loop waits for the device; this holds them
to it, and reads 0 where they keep it.

The program records its spans (``utils/profiling.annotate``) into the
profiler's trace, on the clock of the host's torch and CUDA runtime ops;
the helpers here read them from a traced window's host ops (name, start
ns, duration ns, on the window's thread), and the other span readers load
them from this file.  Each reader returns None where the trace holds no
root span of the program (a program without spans), never 0."""

from __future__ import annotations

import bisect
from collections import Counter

#: The program's spans start with one of these.
SPAN_PREFIXES = ("ppo.", "env.", "rollout.")
#: Runtime calls that wait for the card: the three synchronises and the
#: blocking copy.  A pageable copy to the card and ``.item()`` call
#: ``cudaMemcpyAsync`` then ``cudaStreamSynchronize``.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
#: Runtime calls the host is blocked in: the syncs and every copy (a
#: pageable copy blocks in the copy call itself; a copy on the card
#: returns in microseconds).
WAITS = SYNCS + ("cudaMemcpyAsync",)


def runtime_name(name: str) -> str:
    """A runtime call's name without the suffix CUPTI may give it
    (``_v3020``, ``_ptsz``)."""
    return name.split("_", 1)[0]


def spans(trace, names) -> list:
    """The spans named one of ``names``, as (start ns, end ns), by start."""
    return sorted((s, s + d) for n, s, d in trace.host_ops if n in names)


def inside(trace, roots, kinds) -> list:
    """The host ops of ``kinds`` (runtime names) whose start lies inside
    one of ``roots`` (spans of one level, which do not overlap)."""
    starts = [s for s, _ in roots]
    out = []
    for op in trace.host_ops:
        if runtime_name(op[0]) in kinds:
            i = bisect.bisect_right(starts, op[1]) - 1
            if i >= 0 and op[1] < roots[i][1]:
                out.append(op)
    return out


def innermost(trace, times) -> list:
    """The innermost program span open at each of ``times`` (ns, sorted),
    or None where none is."""
    ops = sorted((op for op in trace.host_ops if op[0].startswith(SPAN_PREFIXES)),
                 key=lambda op: op[1])
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ops) and ops[j][1] <= t:
            stack.append(ops[j])
            j += 1
        stack = [op for op in stack if op[1] + op[2] > t]
        out.append(stack[-1][0] if stack else None)
    return out


def by_caller(trace, root_names, kinds=SYNCS) -> Counter:
    """The ops of ``kinds`` inside the roots, counted by the innermost
    program span around each."""
    ops = sorted(inside(trace, spans(trace, root_names), kinds), key=lambda op: op[1])
    return Counter(innermost(trace, [op[1] for op in ops]))


def syncs_per_call(trace, root_names):
    """Syncs inside the roots over the window's calls; None without roots."""
    if trace is None or not trace.calls:
        return None
    roots = spans(trace, root_names)
    if not roots:
        return None
    return len(inside(trace, roots, SYNCS)) / trace.calls


def mean_ms(trace, name):
    """Mean host duration of the spans ``name``, in ms; None without one."""
    if trace is None:
        return None
    found = spans(trace, (name,))
    return sum(e - s for s, e in found) / len(found) / 1e6 if found else None


def read(run):
    return syncs_per_call(run.trace, ("rollout.call",))
