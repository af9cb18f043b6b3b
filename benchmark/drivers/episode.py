"""The episode rollouts (``ops/*_slab.py`` ``make_*_episode_rollout``):
each call of the window is one rollout of ``steps_per_call`` steps with
uniform random actions and the per-env auto-reset, chained on the states
and running returns of the call before.  The family module
(``families/<family>.py``) makes the rollout and puts each call in the
form ``call(rollout, states, steps, run_return) -> (states, metrics)``,
and replays the checked call in the reference.

Traffic keys: ``num_envs``; ``steps_per_call`` and ``chunk``, each a
number or a map by family; ``warmup_calls``; ``check_within``, the calls
among which the checked one is drawn from the seed."""

from __future__ import annotations

import functools

import torch

from benchmark.drivers import by_family, check_index, family, gap, mismatches, rel_gap

#: The traffic at the CPU tests' size, beside the family's steps and chunk.
TINY = {"num_envs": 48, "warmup_calls": 1, "check_within": 2}


class Driver:
    def __init__(self, cell, seed: int, device, fault=None):
        tr, name = cell.traffic, cell.config["family"]
        self.fam, self.conf = family(name), cell.config["config"]
        self.seed, self.device, self.B = seed, device, tr["num_envs"]
        self.steps, self.chunk = (by_family(tr[k], name) for k in ("steps_per_call", "chunk"))
        cfg = self.fam.config(self.conf)
        self.program = self.fam.make(cfg, self.B, device, self.chunk)
        entry = functools.partial(self.fam.call, self.program)
        self.rollout = entry if fault is None else fault("episode", entry)
        self.wrapper = self.fam.wrapper()
        self.work = {"agent_steps": self.B * cfg.num_agents * self.steps}
        self.first, _ = self.program.reset(seed)
        self.state = self.first
        self.run_ret = torch.zeros((self.B,), dtype=torch.float32, device=device)
        self.warmup = tr["warmup_calls"]
        for _ in range(self.warmup):
            self._call()
        self.check_at = check_index(seed, tr["check_within"])
        self.kept = None
        self.traced = False
        self.episodes = []  # each traced call's finished episodes, for the roofline
        self.launches0 = self.wrapper.launches

    def _call(self):
        self.state, metrics = self.rollout(self.state, self.steps, self.run_ret)
        self.run_ret = metrics["run_return"]
        return metrics

    def call(self, i: int):
        before = (self.state, self.run_ret)
        metrics = self._call()
        if self.traced:
            self.episodes.append(metrics["episodes"])
        if i == self.check_at:
            self.kept = (before, self.state, metrics)

    def counts(self) -> dict:
        """The window's finished episodes and the kernel wrapper's launches."""
        return {"episodes": int(sum(int(e) for e in self.episodes)),
                "launches": self.wrapper.launches - self.launches0,
                "num_envs": self.B, "steps_per_call": self.steps, "chunk": self.chunk}

    def free(self):
        """Drop the program's state but the checked call's."""
        self.state = self.run_ret = self.program = self.rollout = None
        self.episodes = [int(e) for e in self.episodes]

    # -- the check -----------------------------------------------------------

    def check(self, control: bool = False, count=None) -> dict:
        """The compared numbers of the checked call: the program's (or, for
        the control, the reference's in bfloat16) against the reference's
        in float32.  ``count`` gathers what the kernel's roofline needs.
        The finished episodes, the running return and the finished
        episodes' returns are compared where the family's reference gives
        them."""
        if self.kept is None:
            raise RuntimeError(f"the window ended before call {self.check_at}, the checked one")
        (state, run_ret), after, metrics = self.kept
        ref = functools.partial(self.fam.reference, self.conf, self.seed, state, run_ret,
                                self.warmup + self.check_at, self.steps, self.chunk)
        reset, ref_state, ref_rr, ref_sums = ref(torch.float32, count)
        got_reset, got_state = self.fam.flat(self.first, self.B), self.fam.flat(after, self.B)
        got_rr, got = metrics["run_return"], metrics
        if control:
            got_reset, got_state, got_rr, got = ref(torch.bfloat16)
        out = {
            "reset_mismatch": mismatches(got_reset, reset),
            "state_mismatch": mismatches(got_state, ref_state),
        }
        if "episodes" in ref_sums:
            out["episodes_gap"] = abs(int(got["episodes"]) - int(ref_sums["episodes"]))
        if ref_rr is not None:
            out["run_return_gap"] = gap(got_rr, ref_rr)
        for name in ("reward_sum", "ep_return_sum"):
            if name in ref_sums:
                out[f"{name}_gap"] = rel_gap(got[name], ref_sums[name])
        return out
