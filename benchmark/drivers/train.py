"""The PPO learner (``rl/ppo.py`` ``make_ppo``) over a CtF batch env: each
call of the window is one ``train_step(carry, generator)``, the rollout
of ``rollout_len`` steps under the policy then the minibatched update,
chained on the carry.  Set-up builds the learner from the seed and runs
its first ``checked_steps`` train steps through the same call; the
reference follows those steps.  In a traced run each call goes through
the two halves ``make_ppo`` exposes, ``train_step.rollout`` and
``train_step.update``, with CUDA events around each.

Traffic keys: ``num_envs``, ``hidden``, ``ppo`` (``PPOConfig``'s fields),
``checked_steps``, ``trace_seconds``."""

from __future__ import annotations

import statistics

import torch

from benchmark.drivers import port_config, sub_seeds
from benchmark.reference import ppo as ref_ppo
from benchmark.roofline import counts as roofline

#: The traffic at the CPU tests' size (``ppo``'s keys merged into the
#: cell's).
TINY = {"num_envs": 128, "checked_steps": 2,
        "ppo": {"rollout_len": 3, "num_minibatches": 2, "shuffle_blocks": 4}}


def leaf_gaps(got, want, keep) -> list[float]:
    """Each kept leaf's gap between the norms of two lists of tensors, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    g = [float(x.double().norm()) for x in got]
    w = [float(x.double().norm()) for x in want]
    med = statistics.median(w)
    return [abs(g[i] - w[i]) / max(w[i], med) for i in keep]


class Driver:
    def __init__(self, cell, seed: int, device, fault=None):
        from gym_multigrid_tpu_torch.parallel import vector
        from gym_multigrid_tpu_torch.rl.networks import ActorCritic
        from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

        tr = cell.traffic
        self.cell, self.device, self.B = cell, device, tr["num_envs"]
        cfg = port_config(cell.config)
        env = vector.make_ctf_batch(cfg, self.B, device)
        self.ppo_cfg = PPOConfig(**tr["ppo"])
        self.init_seed, self.gen_seed = sub_seeds(seed, 2)
        states, _ = env.reset(0)
        self.obs_dim = int(env.encode(cfg, states).shape[1])
        del states
        self.net = ActorCritic(5, cfg.num_blue_agents, tuple(tr["hidden"]),
                               obs_shape=(self.obs_dim,))
        init_fn, self.train_step = make_ppo(env, self.net, self.ppo_cfg)
        self.train_step.net = self.net
        self.step = self.train_step if fault is None else fault("train", self.train_step)
        self.optimizer, self.carry = init_fn(self.init_seed)
        self.generator = torch.Generator(device=device).manual_seed(self.gen_seed)
        self.start = [p.detach().clone() for p in self.net.parameters()]
        first = []

        def keep_first_moment(opt, args, kwargs):
            if not first:
                first.extend(opt.state[p]["exp_avg"].clone() for p in self.net.parameters())

        hook = self.optimizer.register_step_post_hook(keep_first_moment)
        for _ in range(tr["checked_steps"]):
            self.carry, _ = self.step(self.carry, self.generator)
        hook.remove()
        # Adam's first moment after its first step is (1 - beta1) g.
        self.first_grad = [m / (1 - 0.9) for m in first]
        self.after = [p.detach().clone() for p in self.net.parameters()]
        self.work = {"env_steps": self.B * self.ppo_cfg.rollout_len}
        self.traced = False
        self.halves = []

    def call(self, i: int):
        if not self.traced:
            self.carry, _ = self.step(self.carry, self.generator)
            return
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        self.carry, traj, last_value, _ = self.train_step.rollout(self.carry, self.generator)
        ev[1].record()
        self.train_step.update(traj, last_value, self.generator)
        ev[2].record()
        self.halves.append(ev)

    def counts(self) -> dict:
        dims = roofline.mlp_dims(self.obs_dim, self.cell.traffic["hidden"],
                                 self.cell.config["config"]["num_blue_agents"], 5)
        c = {"model_flops": roofline.model_flops(self.B, self.ppo_cfg.rollout_len,
                                                 self.ppo_cfg.num_epochs, dims)}
        if self.halves:
            c["rollout_ms"] = [a.elapsed_time(b) for a, b, _ in self.halves]
            c["update_ms"] = [b.elapsed_time(e) for _, b, e in self.halves]
        return c

    def free(self):
        self.carry = self.train_step = self.step = self.optimizer = self.net = self.generator = None

    def check(self, control: bool = False, count=None) -> dict:
        tr, steps = self.cell.traffic, self.cell.traffic["checked_steps"]
        first_grad, start, after = ref_ppo.train(self.cell.config["config"], tr, self.B,
                                                 self.init_seed, self.gen_seed, steps,
                                                 self.device)
        got_first, got_start, got_after = self.first_grad, self.start, self.after
        if control:
            got_first, got_start, got_after = ref_ppo.train(
                self.cell.config["config"], tr, self.B, self.init_seed, self.gen_seed, steps,
                self.device, quant=True)
        # Leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam: under a thousandth of the median leaf's.
        norms = [float(g.double().norm()) for g in first_grad]
        med = statistics.median(norms)
        keep = [i for i, n in enumerate(norms) if n >= 1e-3 * med]
        change = leaf_gaps([a - s for a, s in zip(got_after, got_start)],
                           [a - s for a, s in zip(after, start)], keep)
        # The losses and the worst leaf's change read Adam's rounding, which
        # bf16 layers spread over the later minibatches; no control or fault
        # separates them from sound runs, so they are not compared.
        return {
            # The worst leaf of the first minibatch's clipped gradient.
            "first_grad_gap": max(leaf_gaps(got_first, first_grad, keep)),
            # The median leaf's change over the checked steps: the worst
            # leaf's reads the rounding of a small leaf under Adam.
            "median_change_gap": statistics.median(change),
        }
