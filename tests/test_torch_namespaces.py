"""The port's ``envs``, ``parallel`` and ``rl`` namespaces export the names
of the JAX package's (``parallel`` without the GSPMD sharding descriptions
and tensor parallelism, which the port leaves out on purpose), the adapter
classes resolve on first use, and importing the package still loads no
gymnasium, matplotlib or JAX."""

import importlib
import subprocess
import sys

import pytest

#: JAX's ``parallel`` names the port does not have: GSPMD sharding
#: descriptions, and tensor parallelism of the MLP, which one card holds
#: whole (``parallel/mesh.py``).
NOT_PORTED = {"batch_sharding", "batch_tree_shardings", "param_tp_shardings", "replicated"}
NAMESPACES = {"envs": set(), "parallel": NOT_PORTED, "rl": set()}


@pytest.mark.parametrize("namespace", sorted(NAMESPACES))
def test_every_jax_name_imports_from_the_port(namespace):
    jax_ns = importlib.import_module(f"gym_multigrid_tpu.{namespace}")
    port = importlib.import_module(f"gym_multigrid_tpu_torch.{namespace}")
    want = set(jax_ns.__all__) - NAMESPACES[namespace]
    assert set(port.__all__) == want
    for name in sorted(want):
        obj = getattr(port, name)
        assert obj.__module__.startswith("gym_multigrid_tpu_torch."), (name, obj.__module__)
        assert obj.__name__ == name


def test_the_issue_forms_import():
    from gym_multigrid_tpu_torch.envs import CollectConfig
    from gym_multigrid_tpu_torch.parallel import BatchedEnv
    from gym_multigrid_tpu_torch.rl import make_ppo

    assert CollectConfig.__module__ == "gym_multigrid_tpu_torch.envs.collect"
    assert BatchedEnv.__module__ == "gym_multigrid_tpu_torch.parallel.vector"
    assert make_ppo.__module__ == "gym_multigrid_tpu_torch.rl.ppo"


def test_unknown_names_raise_attribute_error():
    import gym_multigrid_tpu_torch.envs as envs

    with pytest.raises(AttributeError, match="no attribute 'NoSuchEnv'"):
        envs.NoSuchEnv


def test_adapter_classes_resolve_lazily_and_the_package_imports_without_them():
    """In a fresh interpreter: the package and its three namespaces load no
    gymnasium, matplotlib or JAX; the first use of an adapter class from
    ``envs`` imports gymnasium and gives the class ``adapters/`` defines."""
    code = """
import sys
import gym_multigrid_tpu_torch
import gym_multigrid_tpu_torch.envs as envs
import gym_multigrid_tpu_torch.parallel, gym_multigrid_tpu_torch.rl
loaded = [m for m in ("gymnasium", "matplotlib", "jax", "gym_multigrid_tpu") if m in sys.modules]
assert not loaded, loaded
from gym_multigrid_tpu_torch.adapters.ctf_adapter import CtFMvNEnv
for name in ("Ctf1v1Env", "CtFMvNEnv", "MazeSingleAgentEnv", "WildfireEnv", "CollectGameEnv",
             "CollectGameEvenDist", "CollectGameQuadrants", "CollectGameQuadrantsRespawn",
             "CollectGameRooms", "CollectGameRoomsFixedHorizon"):
    cls = getattr(envs, name)
    assert cls.__module__.startswith("gym_multigrid_tpu_torch.adapters."), cls
    assert cls.__name__ == name
assert envs.CtFMvNEnv is CtFMvNEnv
assert "gymnasium" in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
