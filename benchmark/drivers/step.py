"""The per-step batch env (``parallel/vector.py`` ``BatchedEnv``): each
call of the window is one ``env.step(states, actions)`` with the
auto-reset, as a policy in the loop drives it, chained on the states of
the call before.  The actions are uniform ids the benchmark draws on the
card from the seed in set-up, a bank of ``action_bank`` batches that the
calls take in turn.

Traffic keys: ``num_envs``, ``action_bank``, ``warmup_calls`` and
``check_within``."""

from __future__ import annotations

import torch

from benchmark.drivers import check_index, gap, mismatches, port_config, sub_seeds
from benchmark.reference import wildfire as ref_wf

#: The traffic at the CPU tests' size.
TINY = {"num_envs": 48, "action_bank": 3, "warmup_calls": 1, "check_within": 2}


class Driver:
    def __init__(self, cell, seed: int, device, fault=None):
        from gym_multigrid_tpu_torch.ops import wildfire_slab
        from gym_multigrid_tpu_torch.parallel import vector

        tr, fam = cell.traffic, cell.config["family"]
        if fam != "wildfire":
            raise ValueError(f"the step driver has no reference for {fam!r}")
        self.cfg_file, self.device, self.B = cell.config, device, tr["num_envs"]
        cfg = port_config(cell.config)
        self.env_seed, act_seed = sub_seeds(seed, 2)
        self.entry = vector.make_wildfire_batch(cfg, self.B, device)
        self.step = self.entry.step if fault is None else fault("step", self.entry.step)
        gen = torch.Generator(device=device).manual_seed(act_seed)
        self.bank = torch.randint(0, 5, (tr["action_bank"], self.B, cfg.num_agents),
                                  generator=gen, device=device, dtype=torch.int32)
        self.wrapper = wildfire_slab.wildfire_step_slab
        self.work = {"agent_steps": self.B * cfg.num_agents}
        self.first, _ = self.entry.reset(self.env_seed)
        self.state = self.first
        self.warmup = tr["warmup_calls"]
        for i in range(self.warmup):
            self.state = self.step(self.state, self.bank[i % len(self.bank)])[0]
        self.check_at = check_index(seed, tr["check_within"])
        self.kept = None
        self.traced = False
        self.launches0 = self.wrapper.launches

    def call(self, i: int):
        before = self.state
        index = self.warmup + i
        out = self.step(before, self.bank[index % len(self.bank)])
        self.state = out[0]
        if i == self.check_at:
            self.kept = (before, index, out)

    def counts(self) -> dict:
        return {"launches": self.wrapper.launches - self.launches0, "num_envs": self.B}

    def free(self):
        self.state = self.entry = self.step = None

    def _reference(self, before, index, fdt):
        t = ref_wf.tables(self.cfg_file["config"])
        B, dev = self.B, self.device
        gen = torch.Generator(device=dev).manual_seed(self.env_seed)
        reset = ref_wf.first_reset(t, gen, B, dev, fdt)
        for _ in range(index):  # the draws of the steps before this one
            torch.rand((B, 1 + t.n_cells), generator=gen, device=dev)
            torch.rand((B, t.n_cells + t.n_fires + t.n_agents), generator=gen, device=dev)
        prog = (before.cells.reshape(B, -1), before.agent_pos.reshape(B, -1), before.step_count,
                before.extinguished)
        state, obs, rewards, term, trunc = ref_wf.batch_step(
            t, prog, self.bank[index % len(self.bank)], gen, fdt)
        return reset, state, obs, rewards, (term, trunc)

    def check(self, control: bool = False, count=None) -> dict:
        if self.kept is None:
            raise RuntimeError(f"the window ended before call {self.check_at}, the checked one")
        before, index, (after, obs, rewards, term, trunc) = self.kept
        B = self.B
        reset, state, r_obs, r_rewards, r_done = self._reference(before, index, torch.float32)
        got = ((self.first.cells.reshape(B, -1), self.first.agent_pos.reshape(B, -1),
                self.first.step_count, self.first.extinguished),
               (after.cells.reshape(B, -1), after.agent_pos.reshape(B, -1), after.step_count,
                after.extinguished), obs, rewards, (term, trunc))
        if control:
            got = self._reference(before, index, torch.bfloat16)
        return {
            "reset_mismatch": mismatches(got[0], reset),
            "state_mismatch": mismatches((*got[1], *got[4]), (*state, *r_done)),
            "obs_mismatch": mismatches((got[2],), (r_obs,)),
            "reward_gap": gap(got[3], r_rewards),
        }
