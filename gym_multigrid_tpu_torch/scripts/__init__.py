"""Command-line entry points of the port: ``python -m
gym_multigrid_tpu_torch.scripts.<name>`` with ``train``, ``evaluate``,
``train_selfplay``, ``league_matrix``, the CtF MvN trainer
``train_mvn_ctf_rl``, the benchmark harnesses ``bench`` and ``bench_all``,
the multi-process runs ``multihost_dryrun``,
``bench_multichip`` and ``audit_comm``, the profiling scripts
``profile_rollout`` and ``sol_record``, the measurements
``bench_ppo_scale``, ``measure_train_step``, ``soak`` and ``sweep_batch``,
and ``plot_learning_curve``."""

import os

#: The checkout's ``artifacts/``: the JAX package's records.
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts")


def out_path(path: str) -> str:
    """``path`` made absolute, after checking that it is not under the
    checkout's ``artifacts/``, whose records are the JAX package's and
    which no script of the port writes."""
    path = os.path.abspath(path)
    if os.path.commonpath([path, ARTIFACTS]) == ARTIFACTS:
        raise ValueError(f"{path} is under {ARTIFACTS}, which holds the JAX package's "
                         "records; write the port's under out/")
    return path
