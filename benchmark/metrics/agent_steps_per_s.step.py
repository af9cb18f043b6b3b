"""``agent_steps_per_s`` of the per-step cell, whose runs spread wider than
the episode cells' and so take a bound of their own."""

from benchmark.harness import metric_reader

read = metric_reader("agent_steps_per_s")
