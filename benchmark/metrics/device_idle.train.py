"""``device_idle.rollout`` of the learner's cell."""

from benchmark.harness import metric_reader

read = metric_reader("device_idle.rollout")
