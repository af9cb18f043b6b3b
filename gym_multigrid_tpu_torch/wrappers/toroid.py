"""Agent-centric toroidal observation of Collect envs (PyTorch port).

Counterpart of ``toroid_obs_fn`` in ``gym_multigrid_tpu/wrappers/toroid.py``:
per agent, a one-hot (H, W, num_ball_types + num_agents) float32 tensor
whose coordinates are shifted so the agent sits at the origin, wrapping
around the board edges.  Channels: each ball color id, the other agents
at depth - 2, walls at depth - 1.  Each channel is a boolean plane of the
board rolled by the agent's position (a gather of the rolled indices, so
that every agent of every env has its own shift).

The gymnasium wrapper ``ToroidObservation`` is in
``adapters/toroid_adapter.py``.
"""

from __future__ import annotations

import torch

from gym_multigrid_tpu_torch.envs.collect import AGENT, BALL, WALL


def toroid_obs_fn(cfg):
    """A function of a Collect state: per env, (A, H, W, depth) float32;
    for a batch, (B, A, H, W, depth), on the state's device.

    depth = num_ball_types + num_agents.  A ball channel is the ball's
    color id; ids at or beyond depth are skipped.  With one agent the
    other-agents channel depth - 2 may share a ball channel, which then
    holds both.  The centred agent itself is left out."""
    w, h = cfg.width, cfg.height
    n_agents = cfg.num_agents
    depth = cfg.num_ball_types + n_agents
    ball_colors = [c for c in sorted(set(cfg.balls_index)) if c < depth]
    channels = [*ball_colors, depth - 2, depth - 1]

    def fn(state):
        obj = torch.as_tensor(state.grid_obj)
        batched = obj.ndim == 2
        obj = obj.reshape(-1, h, w)  # [b, y, x]
        col = torch.as_tensor(state.grid_color).reshape(-1, h, w)
        pos = torch.as_tensor(state.agent_pos).reshape(obj.shape[0], n_agents, 2)  # (x, y)
        dev = obj.device
        planes = torch.stack(
            [(obj == BALL) & (col == c) for c in ball_colors] + [obj == AGENT, obj == WALL],
            dim=1,
        )  # (B, P, H, W)
        # tor[y', x'] = plane[(y' + y) mod H, (x' + x) mod W]: the plane
        # rolled up and left by the agent's position.
        ys = (torch.arange(h, device=dev) + pos[..., 1:2]) % h  # (B, A, H)
        xs = (torch.arange(w, device=dev) + pos[..., 0:1]) % w  # (B, A, W)
        b = torch.arange(obj.shape[0], device=dev)[:, None, None, None, None]
        p = torch.arange(planes.shape[1], device=dev)[None, None, :, None, None]
        rolled = planes[b, p, ys[:, :, None, :, None], xs[:, :, None, None, :]]  # (B, A, P, H, W)
        rolled[:, :, -2, 0, 0] = False  # the centred agent
        tor = torch.zeros((obj.shape[0], n_agents, h, w, depth), dtype=torch.float32, device=dev)
        for k, c in enumerate(channels):
            tor[..., c] = torch.maximum(tor[..., c], rolled[:, :, k].to(torch.float32))
        return tor if batched else tor[0]

    return fn
