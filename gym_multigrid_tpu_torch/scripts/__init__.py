"""Command-line entry points of the port: ``python -m
gym_multigrid_tpu_torch.scripts.<name>`` with ``train``, ``evaluate``,
``train_selfplay``, ``league_matrix``, the multi-process runs
``multihost_dryrun``, ``bench_multichip`` and ``audit_comm``, or the
profiling scripts ``profile_rollout`` and ``sol_record``."""
