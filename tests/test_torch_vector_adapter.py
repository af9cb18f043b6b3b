"""The port's gymnasium ``VectorEnv`` (``adapters/vector_adapter.py``) and
the NEXT_STEP autoreset under it (``parallel/vector.py``) on the CPU,
mirroring ``tests/test_vector_adapter.py``.

Tolerances: obs, flags and states bit-equal; rewards bit-equal (the same
float32 values, widened to float64 on the host).  The unmasked rows of
``next_step_autoreset`` are held to ``BatchedEnv.step`` on the same states
with the same generator state, bit for bit.  Against JAX's
``make_vector_env``: every space and the metadata equal (``==``), and a
Maze episode from a carried JAX state (its step draws nothing) bit-equal
to ``JaxVectorEnv`` across resets.
"""

import dataclasses
import os
import warnings

import gymnasium as gym
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_multigrid_tpu_torch
from gym_multigrid_tpu.adapters import vector_adapter as jva
from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu_torch.adapters.vector_adapter import make_vector_env
from gym_multigrid_tpu_torch.envs.collect import CollectState
from gym_multigrid_tpu_torch.envs.ctf import CtfState
from gym_multigrid_tpu_torch.envs.maze import MazeState
from gym_multigrid_tpu_torch.envs.wildfire import WildfireState
from gym_multigrid_tpu_torch.parallel.vector import make_vector_batch, next_step_autoreset

torch.set_num_threads(1)

FAMILIES = ["collect", "ctf", "maze", "wildfire"]
ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def _venv(family, n, **kw):
    return make_vector_env(family, num_envs=n, device="cpu", **kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_vector_env_api(family):
    venv = _venv(family, 6)
    obs, info = venv.reset(seed=0)
    assert obs.shape[0] == 6 and info == {}
    assert tuple(obs.shape) == tuple(venv.observation_space.shape)
    assert venv.observation_space.contains(obs)
    actions = venv.action_space.sample()
    obs2, rew, term, trunc, info = venv.step(actions)
    assert obs2.shape == obs.shape and obs2.dtype == obs.dtype
    assert rew.shape[0] == 6 and rew.dtype == np.float64
    assert term.shape == trunc.shape == (6,) and term.dtype == bool
    assert np.isfinite(rew).all()
    # A flat vector of every env's actions is taken too.
    venv.step(np.asarray(venv.action_space.sample()).reshape(-1))
    assert isinstance(obs2, np.ndarray)


def test_vector_env_autoreset_next_step():
    """Gymnasium 1.x NEXT_STEP: the finishing step reports the final
    transition; the next step ignores the action and returns the fresh
    episode's first obs with reward 0; real steps resume after that."""
    venv = _venv("collect", 4, max_steps=5)
    venv.reset(seed=1)
    for _ in range(5):
        _, rew, term, trunc, _ = venv.step(venv.action_space.sample())
    assert trunc.all()  # the 5-step horizon, in lockstep
    assert int(venv.states.step_count.max()) == 0  # already reset on the device
    obs_r, rew, term, trunc, _ = venv.step(venv.action_space.sample())
    assert (rew == 0).all()
    assert not term.any() and not trunc.any()
    assert int(venv.states.step_count.max()) == 0
    env = venv._env
    np.testing.assert_array_equal(obs_r, env.encode(env.cfg, venv.states).numpy())
    venv.step(venv.action_space.sample())
    assert int(venv.states.step_count.min()) == 1


def test_vector_env_seed_determinism():
    v1, v2 = _venv("wildfire", 3, size=8), _venv("wildfire", 3, size=8)
    o1, _ = v1.reset(seed=9)
    o2, _ = v2.reset(seed=9)
    np.testing.assert_array_equal(o1, o2)
    a = v1.action_space.sample()
    for x, y in zip(v1.step(a)[:4], v2.step(a)[:4]):
        np.testing.assert_array_equal(x, y)
    # No seed: the first reset is reset(seed=0).
    o3, _ = _venv("wildfire", 3, size=8).reset()
    np.testing.assert_array_equal(o3, _venv("wildfire", 3, size=8).reset(seed=0)[0])


def test_gymnasium_check_env_compliance():
    """Gymnasium's env checker passes on the Wildfire id, whose action
    space covers every agent; the one warning expected is the reward type
    (a per-agent reward array, as the reference returns)."""
    from gymnasium.utils.env_checker import check_env

    gym_multigrid_tpu_torch.register_envs()
    env = gym.make("MultiGridTorch/multigrid-wildfire-v0", device="cpu").unwrapped
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        check_env(env, skip_render_check=True)
    unexpected = [str(w.message) for w in caught
                  if "reward returned by `step()`" not in str(w.message)
                  and "Overriding environment" not in str(w.message)]
    assert not unexpected, unexpected


def test_collect_action_contract():
    """The reference's Discrete action space, one action per agent in
    ``step``: a bare sample is refused, never clamped or replayed."""
    gym_multigrid_tpu_torch.register_envs()
    env = gym.make("MultiGridTorch/multigrid-collect-quadrants-v0", device="cpu").unwrapped
    env.reset(seed=0)
    assert env.action_space.n == 4
    env.step([env.action_space.sample() for _ in env.agents])
    with pytest.raises(ValueError, match="expected 2 actions"):
        env.step(env.action_space.sample())


def _fields(states):
    return [getattr(states, f.name) for f in dataclasses.fields(states)]


def _clone(states):
    return type(states)(*(x.clone() for x in _fields(states)))


@pytest.mark.parametrize("family", FAMILIES)
def test_next_step_autoreset_on_every_family(family):
    """Every row resets several times (max_steps 4; Maze also by reaching
    a flag): masked rows keep their states and report ``encode`` of them
    with reward 0 and no flag; the other rows equal ``BatchedEnv.step`` of
    a second env seeded alike and handed the same states, bit for bit;
    the input states are never written."""
    n = 6
    env, ref = (make_vector_batch(family, n, "cpu", max_steps=4) for _ in range(2))
    states, _ = env.reset(seed=3)
    ref.reset(seed=3)
    mask = torch.zeros((n,), dtype=torch.bool)
    rng = np.random.default_rng(0)
    masked = 0
    for _ in range(14):
        acts = torch.as_tensor(rng.integers(-1, 6, env.actions_shape), dtype=torch.int32)
        before = _clone(states)
        out_states, obs, rew, term, trunc = next_step_autoreset(env, states, acts, mask)
        r_states, r_obs, r_rew, r_term, r_trunc = ref.step(_clone(states), acts)
        for x, y in zip(_fields(states), _fields(before)):
            assert torch.equal(x, y)  # not written
        keep = ~mask
        for got, want in zip(_fields(out_states), _fields(r_states)):
            assert torch.equal(got[keep], want[keep])
        for got, want in ((obs, r_obs), (rew, r_rew), (term, r_term), (trunc, r_trunc)):
            assert torch.equal(got[keep], want[keep])
        for got, want in zip(_fields(out_states), _fields(states)):
            assert torch.equal(got[mask], want[mask])
        fresh = env.encode(env.cfg, states)
        assert torch.equal(obs[mask], fresh[mask])
        assert (rew[mask] == 0).all() and not (term[mask] | trunc[mask]).any()
        masked += int(mask.sum())
        states, mask = out_states, term | trunc
    assert masked >= 2 * n


SPACE_CASES = [
    ("collect", {"agents_index": (1, 2, 3), "size": 15, "max_steps": 20}),
    ("ctf", {"observation_option": "map"}),
    ("maze", {"observation_option": "positional"}),
    ("wildfire", {"size": 8}),
]
SPACE_NAMES = ("observation_space", "action_space", "single_observation_space",
               "single_action_space", "metadata")


@pytest.mark.parametrize("family,kw", SPACE_CASES)
def test_vector_env_spaces_and_metadata_equal_jax(family, kw):
    """The batched and single spaces and the metadata of the port's
    ``make_vector_env`` equal JAX's at the same kwargs (``==``: bounds,
    dtypes and shapes); the defaults are held below."""
    jv = jva.make_vector_env(family, 3, **dict(kw))
    tv = _venv(family, 3, **dict(kw))
    for name in SPACE_NAMES:
        assert getattr(tv, name) == getattr(jv, name), name


STATE_CLASSES = {"collect": CollectState, "ctf": CtfState, "maze": MazeState,
                 "wildfire": WildfireState}


def _carry_batch(jstates, family):
    """A JAX batch state as the port's, field by field."""
    cls = STATE_CLASSES[family]
    return cls(*(torch.tensor(np.asarray(getattr(jstates, f.name)))
                 for f in dataclasses.fields(cls)))


@pytest.mark.parametrize("family", FAMILIES)
def test_vector_env_defaults_equal_jax(family):
    """The family defaults copied from JAX's ``make_vector_env`` (Collect
    quadrants-respawn at 50 steps, CtF 2v2 ``rw`` flattened on
    ``board.txt``, the Maze map, Wildfire's default): the spaces and the
    metadata equal JAX's (``==``), JAX's reset states carried into the
    port encode to JAX's reset obs, bit for bit, and with the step counts
    set about the port's horizon one step of the same actions truncates
    the same rows in both; the config's fields equal those of the config
    JAX's ``make_vector_env`` builds."""
    n = 8
    jv, tv = jva.make_vector_env(family, n), _venv(family, n)
    for name in SPACE_NAMES:
        assert getattr(tv, name) == getattr(jv, name), name
    jobs, _ = jv.reset(seed=1)
    tv.reset(seed=1)
    horizon = tv._env.cfg.max_steps
    counts = np.arange(horizon - 5, horizon - 5 + n, dtype=np.int32)
    jv._states = dataclasses.replace(jv.states, step_count=jnp.asarray(counts))
    tv._next_step.states = _carry_batch(jv.states, family)
    env = tv._env
    np.testing.assert_array_equal(env.encode(env.cfg, tv.states).numpy(), jobs)
    a = np.random.default_rng(3).integers(0, env.num_actions, env.actions_shape)
    jout, tout = jv.step(a), tv.step(a)
    np.testing.assert_array_equal(tout[3], jout[3])
    assert tout[3].any() and not tout[3].all()
    _same_config(env.cfg, JAX_DEFAULTS[family]())


# The configs JAX's ``make_vector_env`` builds with no kwargs
# (``gym_multigrid_tpu/adapters/vector_adapter.py:158-218``).
JAX_DEFAULTS = {
    "collect": lambda: jcollect.CollectConfig(layout="quadrants_respawn", respawn=True,
                                              max_steps=50),
    "ctf": lambda: jctf.CtfConfig.from_map_path(
        os.path.join(ASSETS, "board.txt"), num_blue_agents=2, num_red_agents=2,
        variant="mvn", enemy_policies=(jctf.PolicySpec("rw"), jctf.PolicySpec("rw")),
        observation_option="flattened"),
    "maze": lambda: jmaze.MazeConfig.from_map_path(os.path.join(ASSETS, "board_maze.txt")),
    "wildfire": lambda: jwf.WildfireConfig(),
}


def _same_config(got, want):
    """Every field of the port's config equals JAX's: arrays element for
    element, nested dataclasses (``PolicySpec``) field for field."""
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        elif isinstance(w, tuple) and w and dataclasses.is_dataclass(w[0]):
            assert [dataclasses.asdict(x) for x in g] == [dataclasses.asdict(x) for x in w], f.name
        else:
            assert g == w, f.name


def test_maze_next_step_episode_equals_jax():
    """``TorchVectorEnv`` against ``JaxVectorEnv`` on Maze (max_steps 4,
    so every row finishes several times), from JAX's reset carried in,
    with the same actions (ids 0..4): obs, rewards and flags bit-equal at
    every step, the states equal on the rows that did not reset.  The
    rows a step resets spawn from each package's own draws, so JAX's
    fresh states are carried in after such a step: the held step that
    follows reports their obs with reward 0 and no flag in both."""
    n = 5
    jv = jva.make_vector_env("maze", n, max_steps=4)
    tv = _venv("maze", n, max_steps=4)
    jobs, _ = jv.reset(seed=2)
    tv.reset(seed=2)
    tv._next_step.states = _carry_batch(jv.states, "maze")
    env = tv._env
    np.testing.assert_array_equal(env.encode(env.cfg, tv.states).numpy(), jobs)
    rng = np.random.default_rng(6)
    held = 0
    for t in range(14):
        a = rng.integers(0, 5, n)
        jout, tout = jv.step(a), tv.step(a)
        for got, want in zip(tout[:4], jout[:4]):
            assert got.dtype == want.dtype and got.shape == want.shape, t
            np.testing.assert_array_equal(got, want, err_msg=f"step {t}")
        done = jout[2] | jout[3]
        carried = _carry_batch(jv.states, "maze")
        for f in dataclasses.fields(MazeState):
            np.testing.assert_array_equal(getattr(tv.states, f.name).numpy()[~done],
                                          getattr(carried, f.name).numpy()[~done])
        held += int((jout[1] == 0).sum()) if t and prev_done.any() else 0
        tv._next_step.states = carried
        prev_done = done
    assert held >= n
