"""The episode rollouts (``ops/*_slab.py`` ``make_*_episode_rollout``):
each call of the window is one ``rollout(states, steps_per_call,
run_return)`` with uniform random actions and the per-env auto-reset,
chained on the states and running returns of the call before.

Traffic keys: ``num_envs``; ``steps_per_call`` and ``chunk``, each by
family; ``warmup_calls``; ``check_within``, the calls among which the
checked one is drawn from the seed."""

from __future__ import annotations

import torch

from benchmark.drivers import check_index, gap, mismatches, port_config, rel_gap
from benchmark.reference import ctf as ref_ctf
from benchmark.reference import philox
from benchmark.reference import wildfire as ref_wf


class Driver:
    def __init__(self, cell, seed: int, device, fault=None):
        from gym_multigrid_tpu_torch.ops import ctf_slab, wildfire_slab

        tr, fam = cell.traffic, cell.config["family"]
        self.family, self.cfg_file, self.seed, self.device = fam, cell.config, seed, device
        self.B, self.steps, self.chunk = (tr["num_envs"], tr["steps_per_call"][fam],
                                          tr["chunk"][fam])
        cfg = port_config(cell.config)
        make = {"ctf": ctf_slab.make_ctf_episode_rollout,
                "wildfire": wildfire_slab.make_wildfire_episode_rollout}[fam]
        self.entry = make(cfg, self.B, device=device, chunk=self.chunk)
        self.rollout = self.entry if fault is None else fault("episode", self.entry)
        self.wrapper = {"ctf": ctf_slab.ctf_ms_slab, "wildfire": wildfire_slab.wf_philox_slab}[fam]
        self.work = {"agent_steps": self.B * cfg.num_agents * self.steps}
        self.first, _ = self.entry.reset(seed)
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
        self.state = self.run_ret = self.entry = self.rollout = None
        self.episodes = [int(e) for e in self.episodes]

    # -- the check -----------------------------------------------------------

    def _reference(self, before, fdt, count=None):
        """The reference's reset and its run of the checked call from the
        program's state before it: (reset state, state after, sums)."""
        (state, run_ret), index = before, self.warmup + self.check_at
        B, dev = self.B, self.device
        if self.family == "ctf":
            t = ref_ctf.tables(self.cfg_file["config"])
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            (reset, sc0) = ref_ctf.first_reset(t, gen, B, dev, fdt)
            for _ in range(index):  # the draws of the calls before this one
                for K in ref_ctf.chunk_sizes(self.steps, self.chunk):
                    ref_ctf.episode_draws(t, gen, B, K, dev)
            prog = (state.pos.reshape(B, -1), state.dir, state.terminated, state.collided)
            out, sc, rr, sums = ref_ctf.episode_call(t, prog, state.step_count, run_ret, gen,
                                                     self.steps, self.chunk, fdt)
            return (*reset, sc0), (*out, sc), rr, sums
        t = ref_wf.tables(self.cfg_file["config"])
        key = philox.key_of(self.seed)
        rnd = philox.first_reset_draws(key, B, t.n_cells, t.n_fires + t.n_agents, dev)
        cells, pos = ref_wf.fresh(t, rnd, fdt)
        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        prog = (state.cells.reshape(B, -1), state.agent_pos.reshape(B, -1), state.step_count,
                state.extinguished, run_ret.to(fdt))
        out, sums = ref_wf.episode_call(t, prog, key, index * self.steps, self.steps, self.chunk,
                                        fdt, count)
        return (cells, pos, zeros, zeros), out[:4], out[4], sums

    def _flat(self, state):
        B = self.B
        if self.family == "ctf":
            return (state.pos.reshape(B, -1), state.dir, state.terminated, state.collided,
                    state.step_count)
        return (state.cells.reshape(B, -1), state.agent_pos.reshape(B, -1), state.step_count,
                state.extinguished)

    def check(self, control: bool = False, count=None) -> dict:
        """The compared numbers of the checked call: the program's (or, for
        the control, the reference's in bfloat16) against the reference's
        in float32.  ``count`` gathers what the kernel's roofline needs."""
        if self.kept is None:
            raise RuntimeError(f"the window ended before call {self.check_at}, the checked one")
        before, after, metrics = self.kept
        need = None
        if count is not None and self.family == "wildfire":
            need = count["philox"] = {"calls": 0, "words": 0, "fresh": 0}
        reset, ref_state, ref_rr, ref_sums = self._reference(before, torch.float32, need)
        got_reset, got_state = self._flat(self.first), self._flat(after)
        got_rr, got = metrics["run_return"], metrics
        if control:
            got_reset, got_state, got_rr, got = self._reference(before, torch.bfloat16)
        return {
            "reset_mismatch": mismatches(got_reset, reset),
            "state_mismatch": mismatches(got_state, ref_state),
            "episodes_gap": abs(int(got["episodes"]) - int(ref_sums["episodes"])),
            "run_return_gap": gap(got_rr, ref_rr),
            "reward_sum_gap": rel_gap(got["reward_sum"], ref_sums["reward_sum"]),
            "ep_return_sum_gap": rel_gap(got["ep_return_sum"], ref_sums["ep_return_sum"]),
        }
