"""Scripted agent policies of the port: host classes with ``act``."""

from gym_multigrid_tpu_torch.policy.base import BaseAgentPolicy

__all__ = ["BaseAgentPolicy"]
