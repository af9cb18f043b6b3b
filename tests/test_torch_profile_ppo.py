"""The learner's roofline on the CPU: ``scripts/profile_ppo.py``'s FLOP
model held to the JAX script's (read with ``ast``: importing that script
sets JAX's compilation cache), the port's ``ActorCritic`` layers to flax's,
the record's keys to JAX's, the executed count to the forward rows a train
step really runs; ``sol_record``'s PPO section; ``summarize_profile``'s
``by_class``; and the two names of ``ops``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import gym_multigrid_tpu.ops as jops
from gym_multigrid_tpu.rl import networks as jnet
from gym_multigrid_tpu_torch import ops
from gym_multigrid_tpu_torch.rl.families import make_family_batch
from gym_multigrid_tpu_torch.rl.networks import ActorCritic
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from gym_multigrid_tpu_torch.scripts import profile_ppo, sol_record
from gym_multigrid_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "profile_ppo.py")
TINY = ["--cpu", "--envs", "16", "--rollout-len", "4", "--minibatches", "2", "--iters", "1",
        "--json"]


def _jax_tree():
    with open(JAX_SCRIPT) as f:
        return ast.parse(f.read())


def _jax_functions(*names):
    """The JAX script's top-level functions ``names``, compiled alone."""
    tree = _jax_tree()
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    namespace = {}
    exec(compile(ast.Module(body=defs, type_ignores=[]), JAX_SCRIPT, "exec"), namespace)
    return [namespace[n] for n in names]


def _jax_record_keys():
    """The keys of the dict literal the JAX script's ``main`` assigns to ``rec``."""
    for node in ast.walk(_jax_tree()):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["rec"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec = {...} in the JAX script")


def _obs(family, n=2):
    env, cfg, num_actions, agents = make_family_batch(family, n, "cpu")
    return env.encode(cfg, env.reset(0)[0]), num_actions, agents


@pytest.mark.parametrize("obs_dim, hidden, agents, actions", [
    (216, (256, 256), 2, 5), (300, (64, 32), 2, 4), (169, (128,), 1, 5), (10, (), 3, 7),
])
def test_flop_model_matches_jax(obs_dim, hidden, agents, actions):
    jax_dims, jax_flops = _jax_functions("mlp_dims", "flops_per_sample")
    dims = profile_ppo.mlp_dims(obs_dim, hidden, agents, actions)
    assert dims == jax_dims(obs_dim, hidden, agents, actions)
    assert profile_ppo.flops_per_sample(dims) == jax_flops(dims)


@pytest.mark.parametrize("family", ["ctf", "collect"])
def test_actor_critic_layers_match_flax(family):
    """The port's dense layers are the kernel shapes of flax's
    ``ActorCritic`` initialised on the same obs, and ``mlp_dims``'."""
    obs, num_actions, agents = _obs(family)
    net = ActorCritic(num_actions, agents, obs_shape=tuple(obs.shape[1:]))
    params = jnet.ActorCritic(num_actions=num_actions, num_agents=agents).init(
        jax.random.PRNGKey(0), jnp.asarray(obs[:1].numpy()))["params"]
    flax_dims = [tuple(params[f"Dense_{i}"]["kernel"].shape) for i in range(len(params))]
    assert profile_ppo.linear_dims(net) == flax_dims
    obs_dim = int(np.prod(obs.shape[1:]))
    assert flax_dims == profile_ppo.mlp_dims(obs_dim, net.hidden, agents, num_actions)


def test_ctf_model_flops_at_16_envs_by_4_steps():
    """The count JAX's script prints at 16 envs x 4 steps on the CPU."""
    obs, num_actions, agents = _obs("ctf")
    fwd, _ = profile_ppo.flops_per_sample(profile_ppo.mlp_dims(
        int(np.prod(obs.shape[1:])), (256, 256), agents, num_actions))
    assert fwd == 247_296
    assert profile_ppo.model_flops(16, 4, 1, fwd) == 67_264_512


@pytest.mark.parametrize("trace", [False, True])
def test_record_has_jax_keys_and_no_device_numbers_on_the_cpu(tmp_path, capsys, trace):
    argv = TINY + (["--trace", str(tmp_path)] if trace else [])
    rec = profile_ppo.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(rec))
    want = (_jax_record_keys() - {"mxu_utilization_vs_bf16_peak", "chip"}) | {
        "mfu_vs_bf16_dense_peak", "device", "executed_model_flops_per_train_step"}
    if trace:
        want |= {"observed_profile", "binding_resource"}
    assert set(rec) == want
    assert rec["device"] == "cpu" and rec["backend"] == "cpu"
    assert rec["achieved_model_tflops_per_s"] is None and rec["mfu_vs_bf16_dense_peak"] is None
    assert rec["model_flops_per_train_step"] == 67_264_512
    assert rec["executed_model_flops_per_train_step"] == 16 * (1 + 2 * 4 + 3 * 4) * 247_296
    assert rec["obs_dim"] == 216 and rec["rollout_obs_buffer_gb"] == 16 * 4 * 216 / 1e9
    assert rec["env_steps_per_s"] > 0 and rec["train_step_s"] > 0
    if trace:
        assert rec["observed_profile"]["device"] == "cpu"
        assert rec["observed_profile"].get("by_class") is None
        assert rec["binding_resource"].startswith("not measured")
        assert (tmp_path / "trace.json").exists()


@pytest.mark.parametrize("epochs", [1, 2])
def test_executed_count_is_the_forward_rows_a_train_step_runs(epochs):
    """A forward hook over one train step at B = 4, T = 3: B (1 + 2T)
    rollout rows without gradients, B T E update rows with them; the
    executed count is the rollout rows plus three times the update rows,
    a forward each."""
    B, T = 4, 3
    env, cfg, num_actions, agents = make_family_batch("ctf", B, "cpu")
    obs_shape = tuple(env.encode(cfg, env.reset(0)[0]).shape[1:])
    net = ActorCritic(num_actions, agents, obs_shape=obs_shape, activation_dtype=torch.float32)
    init_fn, train_step = make_ppo(env, net, PPOConfig(rollout_len=T, num_epochs=epochs))
    _, carry = init_fn(0)
    rows = {"rollout": 0, "update": 0}

    def hook(module, inputs, output):
        rows["update" if torch.is_grad_enabled() else "rollout"] += inputs[0].shape[0]

    handle = net.register_forward_hook(hook)
    try:
        train_step(carry, torch.Generator().manual_seed(1))
    finally:
        handle.remove()
    assert rows == {"rollout": B * (1 + 2 * T), "update": B * T * epochs}
    fwd, _ = profile_ppo.flops_per_sample(profile_ppo.linear_dims(net))
    assert profile_ppo.executed_flops(B, T, epochs, fwd) == (
        rows["rollout"] + 3 * rows["update"]) * fwd
    # JAX's model count: the same update, B T + B forwards for the rollout.
    assert profile_ppo.model_flops(B, T, epochs, fwd) == (
        B * T + B + 3 * rows["update"]) * fwd


# Maze's obs are a float map: an empty --obs-buffer-dtype keeps them.
TINY_POINTS = {
    "tiny_a": ["--family", "maze", "--envs", "4", "--rollout-len", "2", "--minibatches", "1",
               "--iters", "1", "--obs-buffer-dtype", ""],
    "tiny_b": ["--family", "maze", "--envs", "8", "--rollout-len", "2", "--minibatches", "2",
               "--iters", "1", "--shuffle-blocks", "2", "--obs-buffer-dtype", ""],
}
SOL_ARGS = ["--cpu", "--families", "maze", "--batch", "8", "--steps", "20"]


def test_sol_record_writes_both_ppo_points(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sol_record, "PPO_POINTS", TINY_POINTS)
    out = tmp_path / "sol.json"
    assert sol_record.main([*SOL_ARGS, "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec["families"]) == {"maze"} and set(rec["ppo_train"]) == set(TINY_POINTS)
    for name, point in rec["ppo_train"].items():
        flags = profile_ppo.parse_args(TINY_POINTS[name])
        assert (point["family"], point["envs"]) == ("maze", flags.envs)
        assert point["device"] == "cpu" and point["mfu_vs_bf16_dense_peak"] is None
        assert point["binding_resource"].startswith("not measured")
        assert (tmp_path / "sol_trace_torch" / f"ppo_{name}" / "trace.json").exists()
    printed = capsys.readouterr().out
    assert "ppo tiny_a:" in printed and "ppo tiny_b:" in printed


def test_sol_record_skip_ppo_writes_no_point(tmp_path, monkeypatch):
    monkeypatch.setattr(sol_record, "PPO_POINTS", TINY_POINTS)
    out = tmp_path / "sol.json"
    assert sol_record.main([*SOL_ARGS, "--skip-ppo", "--out", str(out)]) == 0
    assert "ppo_train" not in json.loads(out.read_text())


def test_sol_record_fails_on_a_failed_point(tmp_path, monkeypatch):
    # 3 envs x 2 steps do not split into 4 minibatches: the point exits 1.
    monkeypatch.setattr(sol_record, "PPO_POINTS", {"bad": [
        "--family", "maze", "--envs", "3", "--rollout-len", "2", "--minibatches", "4",
        "--obs-buffer-dtype", ""]})
    out = tmp_path / "sol.json"
    with pytest.raises(RuntimeError, match="profile_ppo"):
        sol_record.main([*SOL_ARGS, "--out", str(out)])
    assert not out.exists()


def test_ppo_points_are_jax_points_on_ctf():
    assert sol_record.PPO_POINTS == {
        "bench_scale": ["--envs", "8192", "--rollout-len", "32", "--minibatches", "8"],
        "record_1m": ["--envs", "1048576", "--rollout-len", "16", "--minibatches", "128",
                      "--shuffle-blocks", "64"],
    }
    assert {profile_ppo.parse_args(f).family for f in sol_record.PPO_POINTS.values()} == {"ctf"}


def _event(name, device_type, dev_us=0.0, count=1):
    return SimpleNamespace(key=name, name=name, device_type=device_type, count=count,
                           self_device_time_total=dev_us, self_cpu_time_total=0.0,
                           is_user_annotation=False)


def test_summarize_profile_by_class_on_named_cuda_rows():
    """Shares over every kernel, not only the ``top``; the port's kernels
    before the name fragments; the rest ``other``."""
    window = SimpleNamespace(name=profiling.WINDOW, device_type=DeviceType.CPU,
                             time_range=SimpleNamespace(elapsed_us=lambda: 2000.0))
    rows = [
        _event("nvjet_tst_128x288_64x4_2x1_v_bz_coopA_TNT", DeviceType.CUDA, 300.0),
        _event("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", DeviceType.CUDA, 100.0),
        _event("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda",
               DeviceType.CUDA, 250.0, 3),
        _event("void at::native::(anonymous namespace)::CatArrayBatchedCopy<", DeviceType.CUDA,
               50.0),
        _event("void ctf::ctf_step_kernel<2, 2>(CtfArgs)", DeviceType.CUDA, 200.0, 16),
        _event("void at::native::vectorized_elementwise_kernel<8, at::native::tanh_kernel_cuda",
               DeviceType.CUDA, 100.0),
        _event("aten::mm", DeviceType.CPU),
    ]
    prof = SimpleNamespace(key_averages=lambda: rows, events=lambda: [window])
    s = profiling.summarize_profile(prof, top=1)
    assert s["device"] == "cuda" and s["device_us"] == 1000.0 and s["launches"] == 23
    assert s["idle_share"] == 0.5 and len(s["kernels"]) == 1
    assert s["by_class"] == pytest.approx(
        {"matmul": 0.4, "copy": 0.3, "port_kernels": 0.2, "other": 0.1}, abs=1e-12)
    assert profile_ppo.binding_resource(s) == "matmul kernels: 0.400 of the device time"
    assert profile_ppo.binding_resource(dict(s, idle_share=0.75)) == (
        "host: the device idles 0.750 of the wall")


def test_summarize_profile_has_no_by_class_on_the_cpu():
    with profiling.trace() as prof:
        torch.ones(8).sum()
    s = profiling.summarize_profile(prof)
    assert s["device"] == "cpu" and s.get("by_class") is None


def test_card_chip_of_the_cpu_is_none():
    assert profiling.card_chip("cpu") is None


def test_weighted_choice_follows_the_weights():
    """20,000 seeded draws against the weights: chi-square below the 0.1%
    critical value at 3 degrees of freedom (16.27); a zero weight never
    drawn; int32 of the leading shape."""
    weights = torch.tensor([1.0, 0.0, 2.0, 3.0, 0.5])
    n = 20_000
    got = ops.masked_uniform_choice_weighted(weights.expand(n, 5),
                                             torch.Generator().manual_seed(7))
    assert got.dtype == torch.int32 and got.shape == (n,)
    counts = torch.bincount(got.long(), minlength=5).double()
    assert counts[1] == 0
    expected = n * weights.double() / weights.sum()
    live = expected > 0
    chi2 = float(((counts[live] - expected[live]) ** 2 / expected[live]).sum())
    assert chi2 < 16.27, (chi2, counts)


def test_weighted_choice_takes_integer_weights_and_one_row():
    gen = torch.Generator().manual_seed(0)
    got = ops.masked_uniform_choice_weighted(torch.tensor([0, 0, 4, 0]), gen)
    assert got.dtype == torch.int32 and got.shape == () and int(got) == 2
    # No positive weight: index 0, as JAX's argmax over all -inf.
    assert int(ops.masked_uniform_choice_weighted(torch.zeros(3), gen)) == 0


@pytest.mark.parametrize("family", ["collect", "ctf", "maze", "wildfire", "pursuit"])
def test_kernels_available_matches_jax(family):
    assert ops.kernels_available(family) == jops.kernels_available(family)
    assert set(ops.__all__) == {"kernels_available", "masked_uniform_choice_weighted"}


def test_profile_ppo_needs_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        profile_ppo.main(["--envs", "16", "--rollout-len", "4", "--minibatches", "2"])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        sol_record.main(["--families", "maze", "--out", os.path.join(REPO, "out", "x.json")])
    assert e.value.code not in (0, None)


def test_profile_ppo_does_not_import_jax(tmp_path):
    code = f"""
import sys
from gym_multigrid_tpu_torch.scripts import profile_ppo, sol_record
profile_ppo.main({TINY!r})
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not any(m.split(".")[0] == "gym_multigrid_tpu" for m in sys.modules)
print("NO_JAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
