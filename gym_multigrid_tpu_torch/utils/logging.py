"""Persistent training metrics: CSV always, TensorBoard when available
(PyTorch port of ``gym_multigrid_tpu/utils/logging.py``).

Scalars stream to ``<logdir>/metrics.csv`` unconditionally and mirror into
TensorBoard event files when ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import csv
import os
import warnings
from typing import Any, Mapping


class MetricsLogger:
    """Append-only scalar logger: ``log(step, {...})`` then ``close()``."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._csv_path = os.path.join(logdir, "metrics.csv")
        #: last step already in the CSV (-1 if fresh): a resuming caller
        #: continues the step axis from here.
        self.last_step = -1
        self._fields: list[str] | None = None
        if os.path.exists(self._csv_path) and os.path.getsize(self._csv_path):
            # Appending: the existing header is the column contract, so
            # rows never misalign with it.
            with open(self._csv_path) as f:
                rows = [r for r in csv.reader(f) if r]
            if rows:
                self._fields = rows[0][1:]
                if len(rows) > 1:
                    self.last_step = int(float(rows[-1][0]))
        self._csv_file = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir=logdir)

    @property
    def has_tensorboard(self) -> bool:
        return self._tb is not None

    def log(self, step: int, scalars: Mapping[str, Any]) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        if self._fields is None:
            self._fields = sorted(scalars)
            self._csv.writerow(["step", *self._fields])
        elif not set(scalars) <= set(self._fields):
            # The header fixes the columns; extra keys would misalign rows.
            extra = sorted(set(scalars) - set(self._fields))
            warnings.warn(
                f"MetricsLogger: keys {extra} not in the CSV header "
                f"{self._fields}; they go to TensorBoard only",
                stacklevel=2,
            )
        self._csv.writerow(
            [step, *(scalars.get(k, float("nan")) for k in self._fields)]
        )
        self._csv_file.flush()
        self.last_step = step
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._csv_file.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()


def read_metrics_csv(path: str) -> dict[str, list[float]]:
    """Load a metrics.csv back into {column: values}."""
    with open(path) as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        return {}
    header, data = rows[0], rows[1:]
    data = [r for r in data if len(r) == len(header)]
    return {k: [float(r[i]) for r in data] for i, k in enumerate(header)}
