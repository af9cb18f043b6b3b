"""The PPO learner, written out plainly: the MLP actor-critic (hidden
layers in ``act``, bfloat16 as configured, their input, weights and bias
cast to it, the bias added after the product, ``tanh``; the policy and
value heads in float32 on the hidden layer's output), flax's init (each
kernel lecun-normal, a normal truncated at two standard deviations and
rescaled to variance 1 / fan_in, drawn on the CPU layer by layer; biases
zero), Gumbel-max action sampling from exponential draws, GAE with the
truncation bootstrap, SB3's minibatched clipped update with per-minibatch
advantage normalisation, optax's global-norm clip, and Adam (optax's
defaults).  The rollout steps the CtF reference (``reference/ctf.py``).

``quant``, for the control, rounds each hidden layer's input and weights
to float8 (e4m3, one scale a tensor, its largest magnitude at 448) before
the product."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ctf as ref_ctf

TRUNC_STD = 0.87962566103423978  # std of the standard normal cut to [-2, 2]


def init_params(dims, seed: int, device):
    """[(W (out, in), b (out,)) float32] of each dense layer (in, out), in
    order, drawn from a CPU generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for a, b in dims:
        std = math.sqrt(1.0 / a) / TRUNC_STD
        w = torch.empty((b, a), dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
        params += [w.to(device).requires_grad_(), torch.zeros(b, device=device).requires_grad_()]
    return params


def fp8(x):
    """``x`` rounded to float8 e4m3 with one scale for the tensor; the
    gradient passes the rounding unchanged."""
    scale = 448.0 / x.detach().abs().amax().float().clamp(min=1e-12)
    q = ((x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)
    return x + (q - x.detach())


def forward(params, obs, n_agents: int, n_actions: int, act=torch.bfloat16, quant=False):
    """(logits (B, agents, actions) float32, value (B,) float32)."""
    B = obs.shape[0]
    x = obs.reshape(B, -1).to(act) / 10.0
    n_hidden = len(params) // 2 - 2
    for i in range(n_hidden):
        w, b = params[2 * i], params[2 * i + 1]
        xi, wi = x.to(act), w.to(act)
        if quant:
            xi, wi = fp8(xi), fp8(wi)
        x = torch.tanh(F.linear(xi, wi) + b.to(act))
    wp, bp, wv, bv = params[-4:]
    # Each head casts the hidden output to float32 itself (as a flax Dense
    # of float32 does), so their gradients meet in the hidden dtype.
    logits = F.linear(x.to(torch.float32), wp) + bp
    value = (F.linear(x.to(torch.float32), wv) + bv)[:, 0]
    return logits.reshape(B, n_agents, n_actions), value


def sample(logits, gen):
    """(actions (B, agents) int32, summed log-probability (B,))."""
    e = torch.empty_like(logits).exponential_(generator=gen)
    actions = (logits - e.log()).argmax(dim=-1)
    logp = logits.gather(-1, actions[..., None])[..., 0] - torch.logsumexp(logits, dim=-1)
    return actions.to(torch.int32), logp.sum(dim=-1)


def gae(reward, value, term, trunc, boot, last_value, gamma: float, lam: float):
    adv = torch.empty_like(reward)
    g = torch.zeros_like(last_value)
    nxt = last_value
    for t in reversed(range(reward.shape[0])):
        done = torch.maximum(term[t], trunc[t])
        nv = torch.where(trunc[t] > 0, boot[t], nxt)
        delta = reward[t] + gamma * nv * (1.0 - term[t]) - value[t]
        g = delta + gamma * lam * (1.0 - done) * g
        adv[t] = g
        nxt = value[t]
    return adv, adv + value


def rollout(t, ppo: dict, params, env_state, gen_env, gen, shape, quant):
    """``rollout_len`` steps of the batch under the policy: the buffer
    (obs, actions, logp, value, reward, terminated, truncated, bootstrap
    value), the last value, and the env's state after."""
    state, sc = env_state
    obs = ref_ctf.observe(t, state[0], state[2])
    with torch.no_grad():
        logits, value = forward(params, obs, *shape, quant=quant)
        buf = []
        for _ in range(ppo["rollout_len"]):
            actions, logp = sample(logits, gen)
            state, sc, step_obs, reward, term, trunc = ref_ctf.batch_step(
                t, state, sc, actions, gen_env)
            nxt = ref_ctf.observe(t, state[0], state[2])
            B = nxt.shape[0]
            logits2, value2 = forward(params, torch.cat([nxt, step_obs]), *shape, quant=quant)
            buf.append((obs.to(torch.int8), actions, logp, value, reward.float(),
                        term.float(), trunc.float(), value2[B:]))
            obs, logits, value = nxt, logits2[:B], value2[:B]
    traj = [torch.stack(xs) for xs in zip(*buf)]
    return traj, value, (state, sc)


def minibatch_loss(params, mb, ppo: dict, shape, quant):
    """The clipped PPO loss of one minibatch, its advantages normalised
    over the minibatch (population standard deviation)."""
    obs, actions, old_logp, adv, ret = mb
    logits, value = forward(params, obs, *shape, quant=quant)
    lse = torch.logsumexp(logits, dim=-1)
    logp = (logits.gather(-1, actions[..., None].long())[..., 0] - lse).sum(dim=-1)
    ratio = torch.exp(logp - old_logp)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = ppo["clip_eps"]
    pg = -torch.minimum(ratio * adv, ratio.clamp(1 - eps, 1 + eps) * adv).mean()
    v = 0.5 * (value - ret).square().mean()
    ent = (lse - (torch.softmax(logits, dim=-1) * logits).sum(dim=-1)).mean()
    return pg + ppo["vf_coef"] * v - ppo["ent_coef"] * ent


class Adam:
    """optax's adam (betas 0.9 / 0.999, eps 1e-8 outside the root, bias
    corrected) after optax's global-norm clip."""

    def __init__(self, params, lr: float, max_norm: float):
        self.lr, self.max_norm, self.step = lr, max_norm, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    def clip(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        return [g * scale for g in grads]

    def apply(self, params, grads):
        self.step += 1
        c1, c2 = 1 - 0.9 ** self.step, 1 - 0.999 ** self.step
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, self.m, self.v):
                m.lerp_(g, 1 - 0.9)
                v.mul_(0.999).addcmul_(g, g, value=1 - 0.999)
                p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + 1e-8, value=-self.lr / c1)


def update(ppo: dict, params, opt: Adam, traj, last_value, gen, shape, quant, first_grad):
    """``num_epochs`` epochs of minibatched clipped updates.
    ``first_grad`` (a list) gets the clipped gradient of the first update
    ever made."""
    obs, actions, logp, value, reward, term, trunc, boot = traj
    with torch.no_grad():
        adv, ret = gae(reward, value, term, trunc, boot, last_value, ppo["gamma"],
                       ppo["gae_lambda"])
    T, B = reward.shape
    S, M = ppo["shuffle_blocks"], ppo["num_minibatches"]
    n = T * B // S

    def blocks(x):
        x = x.movedim(1, 0)
        return x.reshape((S, n) + x.shape[2:])

    flat = [blocks(x) for x in (obs, actions, logp, adv, ret)]
    rows = torch.arange(S, device=reward.device)[:, None]
    for _ in range(ppo["num_epochs"]):
        perm = torch.rand((S, n), generator=gen, device=reward.device).argsort(dim=1)
        for idx in perm.reshape(S, M, n // M).transpose(0, 1):
            mb = [x[rows, idx].reshape((S * (n // M),) + x.shape[2:]) for x in flat]
            loss = minibatch_loss(params, mb, ppo, shape, quant)
            grads = opt.clip(torch.autograd.grad(loss, params))
            if not first_grad:
                first_grad.extend(g.detach().clone() for g in grads)
            opt.apply(params, grads)


def train(cfg: dict, traffic: dict, num_envs: int, init_seed: int, gen_seed: int, steps: int,
          device, quant: bool = False):
    """``steps`` train steps of the learner from ``init_seed`` (the net's
    and the envs' seeds drawn from it as numpy's ``SeedSequence`` draws
    two words) with actions and shuffles from a generator seeded
    ``gen_seed``.  Returns (the first clipped gradient, the initial
    parameters, the parameters after)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ppo = traffic["ppo"]
    t = ref_ctf.tables(cfg)
    env_seed, net_seed = (int(s) for s in np.random.SeedSequence(init_seed).generate_state(2))
    obs_dim = ref_ctf.observe(t, torch.zeros((1, 2 * t.n_agents), dtype=torch.int32),
                              torch.zeros((1, t.n_agents), dtype=torch.bool)).shape[1]
    shape = (t.n_blue, 5)
    dims, d = [], obs_dim
    for h in traffic["hidden"]:
        dims.append((d, h))
        d = h
    dims += [(d, t.n_blue * 5), (d, 1)]
    params = init_params(dims, net_seed, device)
    start = [p.detach().clone() for p in params]
    gen_env = torch.Generator(device=device).manual_seed(env_seed)
    env = ref_ctf.first_reset(t, gen_env, num_envs, device)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    opt = Adam(params, ppo["lr"], ppo["max_grad_norm"])
    first_grad = []
    for _ in range(steps):
        traj, last_value, env = rollout(t, ppo, params, env, gen_env, gen, shape, quant)
        update(ppo, params, opt, traj, last_value, gen, shape, quant, first_grad)
        del traj
    return first_grad, start, [p.detach() for p in params]
