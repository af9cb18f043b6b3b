"""Render a training run's ``metrics.csv`` into a learning-curve PNG (the
port's ``scripts/plot_learning_curve.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.plot_learning_curve [logdir] [out.png]

``logdir`` defaults to ``out/logs`` (where ``train_mvn_ctf_rl`` logs;
``train`` logs under ``<out>/logs/<family>``), ``out.png`` to
``learning_curve.png`` beside ``logdir``.  Three panels: the mean episode
return (raw and smoothed), the reward per env-step and the policy entropy
against the PPO iteration.  Reads the CSV with ``utils/logging.py``
``read_metrics_csv``; matplotlib (Agg) is imported here only, so the
package runs without it.  Uses no device.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def smooth(x, k: int = 9) -> np.ndarray:
    """Trailing mean over ``k`` points, the first value repeated before
    the start; a series shorter than ``k`` is returned as it is."""
    x = np.asarray(x, dtype=float)
    if len(x) < k:
        return x
    pad = np.concatenate([np.full(k - 1, x[0]), x])
    return np.convolve(pad, np.ones(k) / k, mode="valid")[: len(x)]


def main(argv=None) -> str:
    """Write the PNG; returns its path."""
    from gym_multigrid_tpu_torch.scripts import out_path
    from gym_multigrid_tpu_torch.utils.logging import read_metrics_csv

    argv = sys.argv[1:] if argv is None else argv
    logdir = argv[0] if argv else os.path.join("out", "logs")
    out = out_path(argv[1] if len(argv) > 1
                   else os.path.join(os.path.dirname(os.path.normpath(logdir)),
                                     "learning_curve.png"))
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = read_metrics_csv(os.path.join(logdir, "metrics.csv"))
    steps = np.asarray(m["step"])
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    # Iterations whose rollout window completed no episode log
    # ep_return_mean = 0: drop them rather than average the zeros in.
    ret = np.asarray(m["ep_return_mean"], dtype=float)
    if "episodes" in m:
        has_ep = np.asarray(m["episodes"], dtype=float) > 0
        rsteps, ret = steps[has_ep], ret[has_ep]
    else:
        rsteps = steps
    axes[0].plot(rsteps, ret, alpha=0.25, color="C0")
    axes[0].plot(rsteps, smooth(ret), color="C0")
    if len(ret) > 1:  # short runs may have no completed-episode rows yet
        axes[0].axhline(np.nanmean(ret[1:10]), ls="--", c="grey", lw=1,
                        label="random-policy start")
        axes[0].legend(loc="lower right", fontsize=8)
    # Title from the logdir's family name (logs/<family>); the CtF MvN
    # trainer logs under logs/ directly.
    family = os.path.basename(os.path.normpath(logdir))
    label = {
        "logs": "CtF MvN 2v2 vs scripted reds",
        "ctf": "CtF MvN 2v2 vs scripted reds",
    }.get(family, family)
    axes[0].set_title(f"mean episode return ({label})")
    axes[0].set_xlabel("PPO iteration")
    axes[1].plot(steps, m["reward_per_step"], alpha=0.25, color="C1")
    axes[1].plot(steps, smooth(m["reward_per_step"]), color="C1")
    axes[1].set_title("reward per env-step")
    axes[1].set_xlabel("PPO iteration")
    axes[2].plot(steps, m["entropy"], color="C2")
    axes[2].set_title("policy entropy")
    axes[2].set_xlabel("PPO iteration")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out} ({len(steps)} iterations)")
    return out


if __name__ == "__main__":
    main()
