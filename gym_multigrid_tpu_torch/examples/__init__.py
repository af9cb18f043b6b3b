"""Worked examples of the port: ``python -m
gym_multigrid_tpu_torch.examples.custom_env`` builds a new env on
``BatchedEnv`` and trains it with the stock PPO learner."""
