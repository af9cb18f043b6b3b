"""Command-line entry points of the port: ``python -m
gym_multigrid_tpu_torch.scripts.<name>`` with ``train``, ``evaluate``,
``train_selfplay`` or ``league_matrix``."""
