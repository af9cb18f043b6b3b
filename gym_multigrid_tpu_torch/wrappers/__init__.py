"""Observation wrappers (PyTorch port of ``gym_multigrid_tpu/wrappers/``).

``ToroidObservation`` subclasses a gymnasium wrapper, so it lives in
``adapters/toroid_adapter.py`` and is imported from here on first use:
the package imports without gymnasium."""

from gym_multigrid_tpu_torch.wrappers.toroid import toroid_obs_fn

__all__ = ["ToroidObservation", "toroid_obs_fn"]


def __getattr__(name):
    if name == "ToroidObservation":
        from gym_multigrid_tpu_torch.adapters.toroid_adapter import ToroidObservation

        return ToroidObservation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
