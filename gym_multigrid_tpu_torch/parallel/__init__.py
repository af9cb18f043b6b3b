"""Batched lockstep envs of the port."""
