"""``mfu.rollout`` of the per-step cell, which moves ``agent_steps_per_s.step``."""

from benchmark.harness import metric_reader

read = metric_reader("mfu.rollout")
