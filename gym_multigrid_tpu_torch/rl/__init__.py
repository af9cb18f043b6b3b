"""The PPO learner over the port's batched envs: actor-critic networks,
PPO, the training loop and the family registry.  Exports the names of
``gym_multigrid_tpu.rl``."""

from gym_multigrid_tpu_torch.rl.networks import ActorCritic, sample_actions
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, Transition, make_ppo

__all__ = ["ActorCritic", "sample_actions", "PPOConfig", "Transition", "make_ppo"]
