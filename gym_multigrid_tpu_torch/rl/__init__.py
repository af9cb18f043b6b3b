"""The PPO learner over the port's batched envs: actor-critic networks,
PPO, the training loop and the family registry."""
