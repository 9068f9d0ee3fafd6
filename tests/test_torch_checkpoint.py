"""The port's checkpoints against the JAX package's, on the CPU, at small size
(16 or 64 environments, hidden 32-32).

* ``state_dict()["agent_state"]`` has the JAX agent's paths and shapes for
  the zoo's ``ppo``, ``recurrent_ppo`` (GRU), ``transformer_ppo`` and
  ``amp`` entries and for the optimizer families, less the pinned JAX-only
  leaves (``JAX_ONLY_FIELDS``);
* a port checkpoint file loads through the JAX package's
  ``load_checkpoint_file`` into a JAX agent with no warning, and a JAX file
  into the port; deterministic actions then agree within 1e-6 (fp32);
* a JAX Trainer's ``ckpt_1.npz`` (Adam moments and count after 20 steps, an
  adapted lr scale, the normalizer's statistics) resumes in the port: one
  update on an injected rollout with the JAX sampler's permutations matches
  JAX's resumed update within ``tests/test_torch_update_zoo.py``'s fp32
  tolerances;
* the robustness cases of ``tests/test_checkpoint_robustness.py``: missing,
  extra and mismatched entries warn and keep the initial value, and the
  agent still acts and trains.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.template.logger import LoggerFactory as JaxLoggerFactory
from cusrl_tpu.template.logger import load_checkpoint_file as jax_load_checkpoint_file
from cusrl_tpu.template.logger import save_checkpoint_file as jax_save_checkpoint_file
from cusrl_tpu.template.optimizer import OptimizerFactory as JaxOptimizerFactory
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.template.logger import load_checkpoint_file, save_checkpoint_file
from cusrl_tpu_torch.template.optimizer import OptimizerFactory
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import JAX_ONLY_FIELDS
from cusrl_tpu_torch.zoo.registry import get_experiment

N = 16
SMALL = {
    "ppo": dict(actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 32)),
    "recurrent_ppo": dict(rnn_hidden_size=32, mlp_hidden_dims=(32,)),
    "transformer_ppo": dict(embed_dim=32, num_heads=2, attention_window=4, mlp_hidden_dims=(32,)),
    "amp": dict(actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 32), amp_discriminator_hidden_dims=(32, 32),
                amp_dataset_source=np.random.default_rng(0).standard_normal((256, 32)).astype(np.float32)),
}
FP32_TOL = (dict(rtol=1e-5, atol=5e-6), dict(rtol=0, atol=2e-6), dict(rtol=1e-4, atol=1e-4))


@pytest.fixture(scope="module")
def fp32():
    """Both packages in fp32 (the module's agents are built under it)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(JAX_CONFIG, "compute_dtype", None)
        patch.setattr(CONFIG, "compute_dtype", None)
        patch.setattr(JAX_CONFIG, "seed", 0)
        patch.setattr(jax_misc, "_KEY_COUNTER", [0])
        yield


def _factories(algorithm, **overrides):
    jf = jax_get_experiment("Velocity-Flat", algorithm).make_agent_factory()
    tf = get_experiment("Velocity-Flat", algorithm).make_agent_factory()
    for f in (jf, tf):
        for key, value in {**SMALL[algorithm], **overrides}.items():
            setattr(f, key, value)
    return jf, tf


def _pair(algorithm, n=N, jax_optimizer=None, optimizer=None, **overrides):
    jf, tf = _factories(algorithm, **overrides)
    if optimizer is not None:
        jf, tf = jf.to_underlying(), tf.to_underlying()
        jf.optimizer_factory, tf.optimizer_factory = jax_optimizer, optimizer
    jax_agent = jf(JaxEnv(num_instances=n).spec)
    agent = tf(VelocityLocomotionEnv(num_instances=n, device="cpu").spec, device="cpu")
    return jax_agent, agent


def test_jax_only_fields_are_pinned():
    assert JAX_ONLY_FIELDS == {"AdversarialMotionPrior": ("rng",)}


FAMILIES = [("adam", {}, False), ("adamw", {}, False), ("sgd", {"momentum": 0.9}, False), ("sgd", {}, False),
            ("rmsprop", {}, False), ("adam", {}, True)]


@pytest.mark.parametrize("case", [*SMALL, *(f"{f}{kw}{'packed' if p else ''}" for f, kw, p in FAMILIES)])
def test_agent_state_paths_match_jax(case, fp32, monkeypatch):
    """The port writes every JAX path (shape for shape) but the JAX-only
    ones; ``actor_memory`` has the JAX memory's paths."""
    if case in SMALL:
        jax_agent, agent = _pair(case)
    else:
        family, kwargs, packed = next((f, kw, p) for f, kw, p in FAMILIES if f"{f}{kw}{'packed' if p else ''}" == case)
        monkeypatch.setenv("CUSRL_TPU_PACKED_ADAM", "1" if packed else "0")
        groups = {"critic": {"lr": 1e-4}} if not packed else {}
        jax_agent, agent = _pair("ppo", jax_optimizer=JaxOptimizerFactory(family, 1e-3, dict(kwargs), dict(groups)),
                                 optimizer=OptimizerFactory(family, 1e-3, dict(kwargs), dict(groups)))
    jax_state, state = jax_agent.state_dict(), agent.state_dict()
    jax_only = {f"hooks.{i}.{name}" for i, hook in enumerate(agent.hooks)
                for name in JAX_ONLY_FIELDS.get(type(hook).__name__, ())}
    assert set(state["agent_state"]) == set(jax_state["agent_state"]) - jax_only
    assert jax_only <= set(jax_state["agent_state"])
    for path, value in state["agent_state"].items():
        assert value.shape == np.shape(jax_state["agent_state"][path]), path
    assert set(state) == {"iteration", "agent_state", "actor_memory", "torch_rng"}
    if jax_state["actor_memory"] is None:
        assert state["actor_memory"] is None
    else:
        flat = {p: np.shape(v) for p, v in tree_paths(jax_state["actor_memory"])}
        assert {p: np.shape(v) for p, v in tree_paths(state["actor_memory"])} == flat


def _actions_jax(jax_agent, obs):
    jax_agent.set_inference_mode(True)
    return np.asarray(jax_agent.act(obs))


def _actions(agent, obs):
    agent.set_inference_mode(True)
    return agent.act(obs)


def _observations(seed, n=N):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, 48))).astype(np.float32)


@pytest.fixture(scope="module")
def trained_port(fp32):
    """A port agent after two training iterations (statistics, moments, lr
    scale all moved)."""
    _, tf = _factories("ppo", num_steps_per_update=8)
    env = VelocityLocomotionEnv(num_instances=64, device="cpu")
    agent = tf(env.spec, device="cpu", seed=4)
    driver = RolloutDriver(agent, env)
    for _ in range(2):
        driver.collect_and_update(8)
        agent.apply_schedules(agent.iteration)
    return agent


def test_port_file_loads_in_jax(trained_port, tmp_path):
    path = str(tmp_path / "ckpt_2.npz")
    save_checkpoint_file(path, {"agent": trained_port.state_dict(), "iteration": 2})
    jf, _ = _factories("ppo", num_steps_per_update=8)
    jax_agent = jf(JaxEnv(num_instances=64).spec)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_agent.load_state_dict(jax_load_checkpoint_file(path)["agent"])
    assert not [str(w.message) for w in caught if "checkpoint" in str(w.message).lower()]
    assert jax_agent.iteration == 2
    obs = _observations(1, 64)
    np.testing.assert_allclose(_actions_jax(jax_agent, obs), _actions(trained_port, obs), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_run(fp32, tmp_path_factory):
    """A JAX Trainer's run of one iteration of the zoo's Velocity-Flat/ppo at
    64 environments x 8 steps, hidden 32-32: its ``ckpt_1.npz``."""
    factory = jax_get_experiment("Velocity-Flat", "ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": 64}
    for key, value in {**SMALL["ppo"], "num_steps_per_update": 8}.items():
        setattr(factory.agent, key, value)
    factory.num_iterations = 1
    log_dir = tmp_path_factory.mktemp("jax_logs")
    trainer = factory(logger_factory=JaxLoggerFactory(None, log_dir=str(log_dir)), verbose=False)
    trainer.run_training_loop()
    return str(next(log_dir.glob("*/ckpt/ckpt_1.npz")))


def test_jax_file_loads_in_the_port(jax_run):
    jf, tf = _factories("ppo", num_steps_per_update=8)
    jax_agent = jf(JaxEnv(num_instances=64).spec)
    jax_agent.load_state_dict(jax_load_checkpoint_file(jax_run)["agent"])
    agent = tf(VelocityLocomotionEnv(num_instances=64, device="cpu").spec, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        agent.load_state_dict(load_checkpoint_file(jax_run)["agent"])
    # The JAX file carries no generator state: only that is reported.
    assert [str(w.message) for w in caught] == [
        "ActorCritic: No 'torch_rng' entry (a JAX package checkpoint): the generators keep their seeds."]
    assert agent.iteration == 1
    obs = _observations(2, 64)
    np.testing.assert_allclose(_actions(agent, obs), _actions_jax(jax_agent, obs), rtol=1e-6, atol=1e-6)


def test_jax_checkpoint_resumes_with_the_same_update(jax_run):
    """One update from the JAX Trainer's checkpoint on both sides: the same
    rollout (actions from the JAX actor), the JAX sampler's permutations."""
    jf, tf = _factories("ppo", num_steps_per_update=8)
    checkpoint = jax_load_checkpoint_file(jax_run)["agent"]
    jax_agent = jf(JaxEnv(num_instances=64).spec)
    jax_agent.load_state_dict(checkpoint)
    agent = tf(VelocityLocomotionEnv(num_instances=64, device="cpu").spec, device="cpu")
    agent.load_state_dict(load_checkpoint_file(jax_run)["agent"])
    assert int(checkpoint["agent_state"]["opt_state.0.inner_state.count"]) == 20
    schedule = agent.get_hook("adaptive_l_r_schedule")  # moved from its start (1, 0) by the JAX run
    assert (float(schedule.lr_scale), float(schedule.accumulated_log_error)) != (1.0, 0.0)
    rng = np.random.default_rng(11)
    T, n = 8, 64
    obs = np.tanh(rng.standard_normal((T + 1, n, 48))).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs[:-1]))
    action = np.asarray(dist["mean"] + dist["std"] * rng.standard_normal((T, n, 12)).astype(np.float32))
    terminated, truncated = rng.random((T, n, 1)) < 0.05, rng.random((T, n, 1)) < 0.05
    rollout = {
        "observation": obs[:-1], "next_observation": obs[1:], "action": action,
        "action_logp": np.asarray(jax_agent.state.actor.compute_logp(dist, jnp.asarray(action))),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((T, n, 1)).astype(np.float32),
        "terminated": terminated, "truncated": truncated, "done": terminated | truncated,
    }
    key = jax.random.key(5)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    _, perms, _ = jax_agent.sampler.make_epoch_plan(key, T, n, jax_rollout)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    metrics = agent.update_body(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rollout),
                                epoch_perms=np.array(perms))
    metric_tol, param_tol, state_tol = FP32_TOL
    assert set(metrics) == set(jax_metrics)
    for name, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=name, **metric_tol)
    new = {p: np.asarray(v) for p, v in tree_paths(new_state)}
    for path, value in agent.state_dict()["agent_state"].items():
        tol = param_tol if path.startswith(("actor.", "critic.")) else state_tol
        np.testing.assert_allclose(value.astype(np.float64), new[path].astype(np.float64), err_msg=path, **tol)


# -- robustness (tests/test_checkpoint_robustness.py) ---------------------------


def _trained_small():
    env = VelocityLocomotionEnv(num_instances=8, device="cpu")
    factory = get_experiment("Velocity-Flat", "ppo").make_agent_factory()
    for key, value in dict(num_steps_per_update=8, actor_hidden_dims=(16,), critic_hidden_dims=(16,),
                           sampler_epochs=1, sampler_mini_batches=1).items():
        setattr(factory, key, value)
    agent = factory(env.spec, device="cpu")
    driver = RolloutDriver(agent, env)
    driver.collect_and_update(8)
    return agent, driver


def _still_trains(agent, driver):
    _, metrics = driver.collect_and_update(8)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert np.isfinite(agent.act(_observations(3, 8))).all()


def _first_weight(agent):
    return agent.actor.backbone.layers[0].weight.detach().clone()


def _load(agent, state):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        agent.load_state_dict(state)
    return [str(w.message) for w in caught]


@pytest.mark.parametrize("case", ["roundtrip", "empty", "extra_keys", "missing_entries", "shape_mismatch",
                                  "missing_hook_state", "mismatched_hook_parameter"])
def test_checkpoint_robustness(case):
    agent, driver = _trained_small()
    state = agent.state_dict()
    before = _first_weight(agent)
    if case == "roundtrip":
        generator = agent.generator.get_state()
        torch.randn(3, generator=agent.generator)
        assert not _load(agent, state)
        assert torch.equal(agent.generator.get_state(), generator)
        again = agent.state_dict()["agent_state"]
        assert all(np.array_equal(again[p], v) and again[p].dtype == v.dtype for p, v in state["agent_state"].items())
    elif case == "empty":
        assert _load(agent, {}) == ["ActorCritic: No 'agent_state' entry in checkpoint."]
    elif case == "extra_keys":
        state["__unused1"] = None
        state["agent_state"]["totally.bogus.path"] = np.zeros(3, np.float32)
        assert any("bogus" in m for m in _load(agent, state))
    elif case == "missing_entries":
        for path in [p for p in state["agent_state"] if p.startswith("actor.")]:
            state["agent_state"].pop(path)
        assert any("No checkpoint entry" in m for m in _load(agent, state))
    elif case == "shape_mismatch":
        path = next(p for p in state["agent_state"] if p.startswith("actor") and p.endswith("layers.0.weight"))
        state["agent_state"][path] = np.zeros((1,), np.float32)
        assert any("mismatch" in m.lower() for m in _load(agent, state))
    elif case == "missing_hook_state":
        for path in [p for p in state["agent_state"] if p.startswith("hooks.")]:
            state["agent_state"].pop(path)
        _load(agent, state)
    else:
        path = next(p for p in state["agent_state"] if p.startswith("hooks."))
        state["agent_state"][path] = np.zeros((7, 7), np.float32)
        assert any("mismatch" in m.lower() for m in _load(agent, state))
    assert torch.equal(_first_weight(agent), before)
    _still_trains(agent, driver)


def test_checkpoint_file_layout_matches_jax(trained_port, tmp_path):
    """Both packages' ``save_checkpoint_file`` write the same arrays and
    pickle for the same checkpoint, and each reads the other's."""
    checkpoint = {"agent": trained_port.state_dict(), "stats": {"total_steps": np.asarray(5)}, "iteration": 2}
    save_checkpoint_file(str(tmp_path / "port.npz"), checkpoint)
    jax_save_checkpoint_file(str(tmp_path / "jax.npz"), checkpoint)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["__pickled__", "stats::total_steps"]
        assert np.array_equal(a["__pickled__"], b["__pickled__"])
    for got in (jax_load_checkpoint_file(str(tmp_path / "port.npz")), load_checkpoint_file(str(tmp_path / "jax.npz"))):
        assert got["iteration"] == 2 and int(got["stats"]["total_steps"]) == 5
        assert set(got["agent"]["agent_state"]) == set(checkpoint["agent"]["agent_state"])
