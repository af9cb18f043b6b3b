"""Actor-critic networks of the PPO learner (PyTorch port).

Counterpart of ``gym_multigrid_tpu/rl/networks.py`` (flax.linen).  The
modules compute what the flax ones compute, layer for layer:

- flax's init: every ``Dense``/``Conv`` kernel lecun-normal (a normal
  truncated at two standard deviations, rescaled to variance 1 / fan_in),
  every bias zero (:meth:`reset_parameters`);
- flax's dtypes: each hidden layer casts its input, weight and bias to
  ``activation_dtype`` and returns that dtype (the bias added after the
  product, as flax adds it), the observation is cast before ``/ 10.0``,
  and the heads run in float32.  Autocast would choose other casts, so the
  casts are written out;
- flax's layouts: a ``Dense`` kernel is (in, out) where ``Linear.weight``
  is (out, in); a ``Conv`` kernel is HWIO over NHWC inputs with ``SAME``
  padding where ``Conv2d`` is OIHW over NCHW; the conv torso's output is
  flattened in NHWC order, as flax flattens it.

:func:`load_flax_params` carries a flax ``params`` tree across.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# std of the standard normal truncated to [-2, 2], the factor flax's
# variance_scaling divides by so the truncated draw keeps the variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """Fill ``weight`` in place as flax's ``lecun_normal`` would: drawn on
    the CPU from ``generator`` (so a seed gives the same weights on every
    device), then copied."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(w)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class _FlaxInit(nn.Module):
    """Shared init: lecun-normal kernels, zero biases."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Re-initialise every layer as flax does, from ``generator`` (a
        CPU generator; None draws from the global one)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                _lecun_normal_(m.weight, fan_in, generator)
                with torch.no_grad():
                    m.bias.zero_()


class ActorCritic(_FlaxInit):
    """MLP actor-critic over flattened grid observations: one categorical
    head per agent and a scalar value head.

    ``obs_shape`` is one env's observation shape; flax infers the first
    layer's width from the input at init, a ``Linear`` needs it now."""

    def __init__(
        self,
        num_actions: int,
        num_agents: int = 2,
        hidden: Sequence[int] = (256, 256),
        activation_dtype: torch.dtype = torch.bfloat16,
        *,
        obs_shape: Sequence[int],
    ):
        super().__init__()
        self.num_actions, self.num_agents = num_actions, num_agents
        self.hidden = tuple(hidden)
        self.activation_dtype = activation_dtype
        widths = [int(np.prod(obs_shape)), *hidden]
        self.torso = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.pi = nn.Linear(widths[-1], num_agents * num_actions)
        self.v = nn.Linear(widths[-1], 1)
        self.reset_parameters()

    def forward(self, obs: torch.Tensor):
        """(logits (B, num_agents, num_actions) float32, value (B,) float32)."""
        B = obs.shape[0]
        x = obs.reshape(B, -1).to(self.activation_dtype) / 10.0
        for layer in self.torso:
            x = torch.tanh(_dense(layer, x, self.activation_dtype))
        logits = _dense(self.pi, x, torch.float32)
        value = _dense(self.v, x, torch.float32)[:, 0]
        return logits.reshape(B, self.num_agents, self.num_actions), value


class ConvActorCritic(_FlaxInit):
    """Conv actor-critic over 2-D grid observations: an integer class map
    (H, W), one-hot into ``num_classes`` channels, or a multichannel grid
    (H, W, C); 3x3 ``SAME`` convolutions with ReLU, one tanh ``Dense``,
    then the heads of :class:`ActorCritic`.  ``obs_shape`` is one env's
    observation shape."""

    def __init__(
        self,
        num_actions: int,
        num_agents: int = 2,
        num_classes: int = 8,
        features: Sequence[int] = (32, 64),
        hidden: int = 256,
        activation_dtype: torch.dtype = torch.bfloat16,
        *,
        obs_shape: Sequence[int],
    ):
        super().__init__()
        if len(obs_shape) not in (2, 3):
            raise ValueError(
                f"ConvActorCritic expects (B, H, W) or (B, H, W, C) "
                f"observations, got one env's shape {tuple(obs_shape)}"
            )
        self.num_actions, self.num_agents = num_actions, num_agents
        self.num_classes = num_classes
        self.activation_dtype = activation_dtype
        H, W = obs_shape[:2]
        chans = [num_classes if len(obs_shape) == 2 else obs_shape[2], *features]
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:])
        )
        self.dense = nn.Linear(H * W * chans[-1], hidden)
        self.pi = nn.Linear(hidden, num_agents * num_actions)
        self.v = nn.Linear(hidden, 1)
        self.reset_parameters()

    def forward(self, obs: torch.Tensor):
        """(logits (B, num_agents, num_actions) float32, value (B,) float32)."""
        dt = self.activation_dtype
        B = obs.shape[0]
        if obs.ndim == 3:
            # jax.nn.one_hot: a class outside 0..num_classes-1 is all zeros.
            classes = torch.arange(self.num_classes, device=obs.device)
            x = (obs.long()[..., None] == classes).to(dt)
        elif obs.ndim == 4:
            x = obs.to(dt) / 10.0
        else:
            raise ValueError(
                f"ConvActorCritic expects (B, H, W) or (B, H, W, C) "
                f"observations, got shape {tuple(obs.shape)}"
            )
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(dt), padding=1) + conv.bias.to(dt)[:, None, None]
            x = torch.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(B, -1)  # flatten as flax does: (H, W, C)
        x = torch.tanh(_dense(self.dense, x, dt))
        logits = _dense(self.pi, x, torch.float32)
        value = _dense(self.v, x, torch.float32)[:, 0]
        return logits.reshape(B, self.num_agents, self.num_actions), value


def sample_actions(logits: torch.Tensor, generator: torch.Generator | None = None):
    """Per-agent actions and the joint log-probability from (B, A, n)
    logits: (actions (B, A) int32, logp (B,) float32).

    The draw is Gumbel-max (``argmax(logits - log E)``, E exponential), the
    distribution of JAX's ``jax.random.categorical``; the log-probability
    is ``logit[action] - logsumexp(logits)`` summed over the agents."""
    e = torch.empty_like(logits).exponential_(generator=generator)
    actions = (logits - e.log()).argmax(dim=-1)
    chosen = logits.gather(-1, actions[..., None])[..., 0]
    logp = chosen - torch.logsumexp(logits, dim=-1)
    return actions.to(torch.int32), logp.sum(dim=-1)


def load_flax_params(net: nn.Module, params) -> None:
    """Load a flax ``params`` tree (nested dicts of arrays, with or without
    the outer ``"params"`` key) into ``net``, in place.

    flax names layers by kind in creation order (``Dense_0``, ``Conv_0``,
    ...); the modules here register theirs in that order.  Raises unless
    the layer names and every shape agree."""
    tree = params.get("params", params)
    counts = {"Dense": 0, "Conv": 0}
    layers = {}
    for m in net.modules():
        kind = "Dense" if isinstance(m, nn.Linear) else "Conv" if isinstance(m, nn.Conv2d) else None
        if kind is not None:
            layers[f"{kind}_{counts[kind]}"] = m
            counts[kind] += 1
    if set(layers) != set(tree):
        raise ValueError(f"flax params have layers {sorted(tree)}, the module {sorted(layers)}")
    for name, m in layers.items():
        kernel = np.asarray(tree[name]["kernel"], dtype=np.float32)
        bias = np.asarray(tree[name]["bias"], dtype=np.float32)
        # Dense (in, out) -> (out, in); Conv HWIO -> OIHW.
        w = kernel.T if isinstance(m, nn.Linear) else kernel.transpose(3, 2, 0, 1)
        if w.shape != tuple(m.weight.shape) or bias.shape != tuple(m.bias.shape):
            raise ValueError(
                f"{name}: flax kernel {kernel.shape} / bias {bias.shape} do not fit "
                f"weight {tuple(m.weight.shape)} / bias {tuple(m.bias.shape)}"
            )
        with torch.no_grad():
            m.weight.copy_(torch.tensor(w))
            m.bias.copy_(torch.tensor(bias))
