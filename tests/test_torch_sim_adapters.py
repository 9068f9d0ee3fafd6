"""The IsaacLab and mjlab adapters of the port against the JAX package's, on
the CPU, over the JAX tests' fake simulator (``tests/test_sim_adapters.py``'s
``FakeSimEnv``: torch tensors, ``policy``/``critic`` groups, autoreset with
missing final states, ``extras["log"]``) and fake ``isaaclab``,
``isaaclab_tasks``, ``gymnasium`` and ``mjlab`` modules.

Each test builds both sides on fakes of the same seed: the specs, the
observation groups, every step's arrays (the port's tensors exactly equal to
JAX's numpy, with the stated dtypes and shapes, device copies of the
simulator's tensors), the metrics, the demonstration sampler feeding AMP, the
launchers' glue, ``TrainerCfg``, ``MjlabPlayer`` and ``make_mjlab_env``.
One whole iteration of the ``Isaac-Velocity-Rough-Anymal-C-v0``/``ppo``
entry (hidden dims cut to (32, 16), 16 environments at the uncut 235-wide
observation and 12-wide action) runs through the JAX Trainer's host loop and
the port's on the same weights, actions and minibatch plan
(``tests/test_torch_host_loop.py``'s method): observations exactly, metrics
at ``BF16_TOL`` (the differences of nearly equal terms as the recurrent and
transformer update tests hold them), and again in fp32.  The port's host
loops on tensors (the Trainer's and the Player's, on an environment that
autoresets and on one reset by index) give their numpy loops' numbers, and
its ``_log_iteration`` logs JAX's ``Environment/<key>`` entries.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from cusrl_tpu.environment.isaaclab import IsaacLabEnvAdapter as JaxIsaacLabEnvAdapter
from cusrl_tpu.environment.isaaclab import IsaacLabEnvLauncher as JaxIsaacLabEnvLauncher
from cusrl_tpu.environment.isaaclab import TrainerCfg as JaxTrainerCfg
from cusrl_tpu.environment.isaaclab import make_isaaclab_env as jax_make_isaaclab_env
from cusrl_tpu.environment.mjlab import MjlabEnvAdapter as JaxMjlabEnvAdapter
from cusrl_tpu.environment.mjlab import MjlabPlayer as JaxMjlabPlayer
from cusrl_tpu.environment.mjlab import make_mjlab_env as jax_make_mjlab_env
from cusrl_tpu.environment.mjlab import make_mjlab_env_config as jax_make_mjlab_env_config
from cusrl_tpu.template.trainer import Trainer as JaxTrainer
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment import (
    IsaacLabEnvAdapter,
    IsaacLabEnvLauncher,
    MjlabEnvAdapter,
    MjlabPlayer,
    TrainerCfg,
    make_isaaclab_env,
    make_mjlab_env,
)
from cusrl_tpu_torch.environment.mjlab import make_mjlab_env_config
from cusrl_tpu_torch.nn.kernels.fused_mlp import LAUNCHES, reset_launch_counts
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.template.player import Player
from cusrl_tpu_torch.template.trainer import Trainer
from cusrl_tpu_torch.testing.environment import DummyEnvironment
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment
from tests.test_sim_adapters import FakeSimEnv, _GroupSpace

BF16_TOL = dict(rtol=1e-3, atol=1e-4)  # the metrics' of tests/test_torch_update_zoo.py
METRIC_TOL = {"bfloat16": BF16_TOL, None: dict(rtol=1e-5, atol=5e-6)}  # fp32: tests/test_torch_update_zoo.py's
# The metrics that are small differences of nearly equal terms carry the
# rounding amplified by 20 Adam steps at lr 1e-3 on the unnormalized 235-wide
# input, as in tests/test_torch_update_recurrent.py and
# tests/test_torch_update_transformer.py: in bf16 0.15 % on the
# importance-weighted advantage and 0.32 % on the KL, in fp32 8.4e-5 on the
# importance-weighted advantage; every other metric agrees to 1e-4 in bf16.
DIFFERENCE_METRICS = ("kl_divergence", "importance_weighted_advantage", "ratio", "surrogate_loss")
DIFFERENCE_TOL = {"bfloat16": dict(rtol=2e-2, atol=1e-4), None: BF16_TOL}
ADAPTERS = {"isaaclab": (IsaacLabEnvAdapter, JaxIsaacLabEnvAdapter), "mjlab": (MjlabEnvAdapter, JaxMjlabEnvAdapter)}
ANYMAL = ("Isaac-Velocity-Rough-Anymal-C-v0", "ppo")
ANYMAL_OBS, ANYMAL_ACT, ANYMAL_ENVS = 235, 12, 16  # LocomotionVelocityRoughEnvCfg's policy group and action


def _fake(critic: bool = True, **kwargs) -> FakeSimEnv:
    fake = FakeSimEnv(**kwargs)
    if not critic:
        fake.observation_space = _GroupSpace(fake.num_envs, fake._obs_dim, None)
    return fake


def _pair(kind: str, critic: bool = True, **kwargs):
    port, jax_cls = ADAPTERS[kind]
    return port(_fake(critic, **kwargs)), jax_cls(_fake(critic, **kwargs))


def _assert_equal(got, want, dtype, shape, what):
    assert isinstance(got, torch.Tensor) and got.dtype == dtype and tuple(got.shape) == shape, what
    assert want.shape == shape, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


@pytest.mark.parametrize("critic", [True, False], ids=["critic", "no_critic"])
@pytest.mark.parametrize("kind", list(ADAPTERS))
def test_spec_and_observation_groups_match_jax(kind, critic):
    env, jax_env = _pair(kind, critic)
    for name in ("observation_dim", "action_dim", "num_instances", "state_dim", "reward_dim", "autoreset",
                 "final_state_is_missing", "timestep"):
        assert getattr(env.spec, name) == getattr(jax_env.spec, name), name
    assert (env.spec.observation_dim, env.spec.action_dim, env.num_instances) == (6, 3, 8)
    assert env.spec.state_dim == (9 if critic else None)
    assert env.spec.autoreset and env.spec.final_state_is_missing and env.spec.timestep == pytest.approx(0.02)
    obs, state, _ = env.reset()
    jax_obs, jax_state, _ = jax_env.reset()
    _assert_equal(obs, jax_obs, torch.float32, (8, 6), "observation")
    if critic:
        _assert_equal(state, jax_state, torch.float32, (8, 9), "state")
    else:
        assert state is None and jax_state is None


@pytest.mark.parametrize("kind", list(ADAPTERS))
def test_step_matches_jax_exactly(kind):
    """40 steps across the fake's 25-step truncation: every array equal to
    JAX's, the agent's action tensor handed to the simulator as it is, the
    simulator's observation handed back as a copy, the autoreset's first
    observation of a new episode in place of the missing final one."""
    env, jax_env = _pair(kind)
    env.reset()
    jax_env.reset()
    fake = env.wrapped
    returned = []
    step = fake.step
    fake.step = lambda action: (lambda out: (returned.append(out[0]["policy"]), out)[1])(step(action))
    rng = np.random.default_rng(3)
    terminations = truncations = 0
    for _ in range(40):
        action = rng.standard_normal((8, 3)).astype(np.float32)
        action_t = torch.from_numpy(action)
        got, want = env.step(action_t), jax_env.step(action)
        assert fake.received_actions[-1] is action_t  # same device and dtype: no copy
        assert got[0].data_ptr() != returned[-1].data_ptr()  # a copy: the simulator may rewrite its buffer
        for i, (dtype, width, what) in enumerate(((torch.float32, 6, "observation"), (torch.float32, 9, "state"),
                                                  (torch.float32, 1, "reward"), (torch.bool, 1, "terminated"),
                                                  (torch.bool, 1, "truncated"))):
            _assert_equal(got[i], want[i], dtype, (8, width), what)
        assert got[5] == want[5] == {}
        terminations += int(got[3].sum())
        truncations += int(got[4].sum())
    assert terminations and truncations  # episodes end both ways and restart in place
    np.testing.assert_array_equal(env.step(np.zeros((8, 3), np.float32))[0].numpy(),
                                  jax_env.step(np.zeros((8, 3), np.float32))[0])  # numpy actions as well
    env.close()
    assert fake.closed


@pytest.mark.parametrize("kind", list(ADAPTERS))
def test_get_metrics_matches_jax(kind):
    env, jax_env = _pair(kind)
    assert env.get_metrics() == jax_env.get_metrics() == {}
    env.reset()
    jax_env.reset()
    env.step(torch.zeros(8, 3))
    jax_env.step(np.zeros((8, 3), np.float32))
    metrics, jax_metrics = env.get_metrics(), jax_env.get_metrics()
    assert metrics == pytest.approx(jax_metrics, rel=1e-7)
    assert metrics == {"Episode_Reward/tracking": 1.0, "Metrics/feet_air": 2.0}


def test_demonstration_sampler_feeds_the_amp_hook_as_jax():
    """The IsaacLab adapter's sampler is the simulator's
    ``collect_reference_motions``: its tensor reaches the AMP hook as it is
    (no host copy), with the rows JAX's hook holds; mjlab has none."""
    env = IsaacLabEnvAdapter(_fake(with_motions=True))
    jax_env = JaxIsaacLabEnvAdapter(_fake(with_motions=True))
    assert MjlabEnvAdapter(_fake(with_motions=True)).spec.demonstration_sampler is None
    assert JaxMjlabEnvAdapter(_fake(with_motions=True)).spec.demonstration_sampler is None
    torch.manual_seed(0)
    sample = env.spec.demonstration_sampler(5)
    torch.manual_seed(0)
    jax_sample = jax_env.spec.demonstration_sampler(5)
    assert isinstance(sample, torch.Tensor) and isinstance(jax_sample, np.ndarray)
    np.testing.assert_array_equal(sample.numpy(), jax_sample)

    entry = jax_get_experiment("Isaac-Humanoid-AMP-Walk-Direct-v0", "amp"), get_experiment(
        "Isaac-Humanoid-AMP-Walk-Direct-v0", "amp")
    jf, tf = (spec.make_agent_factory() for spec in entry)
    for f in (jf, tf):
        f.actor_hidden_dims = f.critic_hidden_dims = f.amp_discriminator_hidden_dims = (16,)
    drawn = []
    sampler = env.spec.demonstration_sampler
    env.spec.demonstration_sampler = lambda n: (drawn.append(sampler(n)), drawn[-1])[1]
    torch.manual_seed(1)
    agent = tf(env.spec, device="cpu")
    torch.manual_seed(1)
    jax_agent = jf(jax_env.spec)
    dataset = agent.get_hook("adversarial_motion_prior").dataset
    assert dataset is drawn[0] and tuple(dataset.shape) == (65536, 9)
    np.testing.assert_array_equal(dataset.numpy(), np.asarray(jax_agent.get_hook("adversarial_motion_prior").dataset))


class _FakeApp:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def _install_isaaclab(monkeypatch, created: dict) -> None:
    """Fake ``isaaclab.app``, ``isaaclab_tasks``, its ``parse_env_cfg``,
    ``gymnasium`` and an extension ``robot_ext`` (as the JAX test's), which
    record what the launcher passes them."""

    class AppLauncher:
        @staticmethod
        def add_app_launcher_args(parser):
            parser.add_argument("--headless", action="store_true")

        def __init__(self, args):
            created["headless"] = args.headless
            created.setdefault("apps", []).append(_FakeApp())
            self.app = created["apps"][-1]

    class Cfg:
        pass

    def parse_env_cfg(task, num_envs=None, **kwargs):
        created.update(task=task, num_envs=num_envs, parse_kwargs=kwargs)
        return Cfg()

    def gym_make(task, cfg=None):
        created.update(made=task, episode_length_s=getattr(cfg, "episode_length_s", None))
        return FakeSimEnv(num_envs=4)

    def module(name, **attrs):
        mod = types.ModuleType(name)
        for key, value in attrs.items():
            setattr(mod, key, value)
        return mod

    def extension_tasks():
        created.setdefault("extensions", []).append("robot_ext.tasks")
        return module("robot_ext.tasks")

    app = module("isaaclab.app", AppLauncher=AppLauncher)
    parse = module("isaaclab_tasks.utils.parse_cfg", parse_env_cfg=parse_env_cfg)
    utils = module("isaaclab_tasks.utils", parse_cfg=parse)
    modules = {"isaaclab": module("isaaclab", app=app), "isaaclab.app": app, "isaaclab_tasks": module("isaaclab_tasks"),
               "isaaclab_tasks.utils": utils, "isaaclab_tasks.utils.parse_cfg": parse,
               "gymnasium": module("gymnasium", make=gym_make), "robot_ext": module("robot_ext")}
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.delitem(sys.modules, "robot_ext.tasks", raising=False)

    import importlib

    real_import = importlib.import_module
    monkeypatch.setattr(importlib, "import_module", lambda name, package=None: (
        extension_tasks() if name == "robot_ext.tasks" else real_import(name, package)))


def test_isaaclab_launcher_glue_matches_jax(monkeypatch):
    records = []
    for make, launcher in ((make_isaaclab_env, IsaacLabEnvLauncher),
                           (jax_make_isaaclab_env, JaxIsaacLabEnvLauncher)):
        created = {}
        _install_isaaclab(monkeypatch, created)
        env = launcher("Isaac-Velocity-Flat-Anymal-D-v0", num_envs=4, extensions=("robot_ext",),
                       episode_length_s=5.0)
        assert env.num_instances == 4 and not created["apps"][0].closed
        env.close()
        assert created["apps"][0].closed and env.wrapped.closed
        first = dict(created)
        play = make("Isaac-Velocity-Flat-Anymal-D-v0", num_envs=4, play=True)
        records.append((first, dict(created)))
        play.close()
    (first, play), (jax_first, jax_play) = records
    assert first["headless"] is jax_first["headless"] is True
    assert first["episode_length_s"] == jax_first["episode_length_s"] == 5.0  # kwargs set on the parsed configuration
    assert (first["task"], first["num_envs"]) == (jax_first["task"], jax_first["num_envs"]) == (
        "Isaac-Velocity-Flat-Anymal-D-v0", 4)
    assert first["extensions"] == jax_first["extensions"] == ["robot_ext.tasks"]
    assert first["parse_kwargs"] == jax_first["parse_kwargs"] == {}
    assert play["task"] == jax_play["task"] == play["made"] == "Isaac-Velocity-Flat-Anymal-D-Play-v0"
    assert play["headless"] is jax_play["headless"] is False

    created = {}
    _install_isaaclab(monkeypatch, created)
    make_isaaclab_env("Isaac-Velocity-Rough-Anymal-C-v0", device="cpu").close()
    assert created["parse_kwargs"] == {"device": "cpu"}  # the zoo's device reaches the simulator's configuration


def test_a_missing_simulator_raises_as_jax(monkeypatch):
    for name in ("isaaclab", "isaaclab.app", "mjlab", "mjlab.env", "mjlab.envs", "mjlab.tasks",
                 "mjlab.tasks.registry"):
        monkeypatch.setitem(sys.modules, name, None)
    for port, jax_fn, args in ((IsaacLabEnvLauncher, JaxIsaacLabEnvLauncher, ("Isaac-Cartpole-v0",)),
                               (make_mjlab_env, jax_make_mjlab_env, ("Mjlab-Velocity-Flat-Unitree-G1",)),
                               (make_mjlab_env_config, jax_make_mjlab_env_config, ("Mjlab-Velocity-Flat-Unitree-G1",))):
        with pytest.raises(ImportError) as error:
            port(*args)
        with pytest.raises(ImportError) as jax_error:
            jax_fn(*args)
        assert str(error.value) == str(jax_error.value)
    factory = get_experiment(*ANYMAL).to_training_factory()
    with pytest.raises(ImportError, match="IsaacLab installation"):
        factory(device="cpu", verbose=False)


def _small_ppo(spec_name=ANYMAL):
    factories = jax_get_experiment(*spec_name).make_agent_factory(), get_experiment(*spec_name).make_agent_factory()
    for f in factories:
        f.actor_hidden_dims = f.critic_hidden_dims = (16,)
        f.num_steps_per_update = 8
    return factories


def test_trainer_cfg_builds_the_ports_trainer(tmp_path, monkeypatch):
    monkeypatch.setattr(CONFIG, "seed", CONFIG.seed)
    monkeypatch.setattr(JAX_CONFIG, "seed", JAX_CONFIG.seed)
    fields = {f.name: f.default for f in dataclasses.fields(TrainerCfg)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxTrainerCfg)}
    assert fields == {**jax_fields, "device": None}  # the port's entry points take a device
    jf, tf = _small_ppo()
    kwargs = dict(num_iterations=2, seed=3, logger=None)
    trainer = TrainerCfg(agent_factory=tf, device="cpu", log_dir=str(tmp_path / "port"), **kwargs)(
        IsaacLabEnvAdapter(_fake()))
    jax_trainer = JaxTrainerCfg(agent_factory=jf, log_dir=str(tmp_path / "jax"), **kwargs)(
        JaxIsaacLabEnvAdapter(_fake()))
    assert isinstance(trainer, Trainer) and trainer.agent.device.type == "cpu" and trainer.driver is None
    assert CONFIG.seed == 3 and trainer.num_iterations == jax_trainer.num_iterations == 2
    assert trainer.checkpoint_interval == jax_trainer.checkpoint_interval == 50
    trainer.run_training_loop()
    assert trainer.agent.iteration == 2 and trainer.stats.total_steps == 2 * 8 * 8
    assert len(list((tmp_path / "port").rglob("ckpt_2.npz"))) == 1


def test_mjlab_player_is_a_policy_callable_as_jax(monkeypatch):
    """``MjlabPlayer`` on the same checkpoint as JAX's: the deterministic
    action of an observation dict (a tensor on the agent's device), and,
    without ``mjlab.viewer``, the Player's own loop with the simulator's
    metrics in its summary."""
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    monkeypatch.setitem(sys.modules, "mjlab.viewer", None)
    jf, tf = _small_ppo(("Mjlab-Velocity-Flat-Unitree-G1", "ppo"))
    checkpoint = {"agent": jf(JaxMjlabEnvAdapter(_fake()).spec).state_dict()}
    fakes = _fake(), _fake()
    player = MjlabPlayer(environment=MjlabEnvAdapter(fakes[0]), agent_factory=tf, checkpoint=checkpoint, num_steps=30,
                         timestep=0, verbose=False, device="cpu")
    jax_player = JaxMjlabPlayer(environment=JaxMjlabEnvAdapter(fakes[1]), agent_factory=jf, checkpoint=checkpoint,
                                num_steps=30, timestep=0, verbose=False)
    observation_dict = _fake(seed=9)._obs()
    action = player(observation_dict)
    assert isinstance(action, torch.Tensor) and tuple(action.shape) == (8, 3)
    np.testing.assert_allclose(action.numpy(), np.asarray(jax_player(observation_dict)), rtol=1e-5, atol=1e-6)
    summary, jax_summary = player.run_playing_loop(), jax_player.run_playing_loop()
    assert player.steps_taken == 30 and set(summary) == set(jax_summary)
    assert {"step_reward", "episode_reward", "Episode_Reward/tracking", "Metrics/feet_air"} <= set(summary)
    for key in summary:
        np.testing.assert_allclose(summary[key], jax_summary[key], rtol=1e-6, err_msg=key)


def _install_mjlab(monkeypatch, created: dict) -> None:
    """Fake ``mjlab.env``, ``mjlab.envs`` and ``mjlab.tasks.registry`` (as the JAX test's)."""

    @dataclasses.dataclass
    class ManagerBasedRlEnvCfg:
        episode_length_s: float = 10.0
        decimation: int = 2

    def manager_env(cfg=None, **kwargs):
        created.update(cfg=cfg, kwargs=kwargs)
        return FakeSimEnv(num_envs=4)

    def load_env_cfg(task_id, play=False):
        created["loaded"] = (task_id, play)
        return ManagerBasedRlEnvCfg(episode_length_s=3.0)

    env_mod = types.ModuleType("mjlab.env")
    env_mod.ManagerBasedRlEnv = manager_env
    envs_mod = types.ModuleType("mjlab.envs")
    envs_mod.ManagerBasedRlEnvCfg = ManagerBasedRlEnvCfg
    registry_mod = types.ModuleType("mjlab.tasks.registry")
    registry_mod.load_env_cfg = load_env_cfg
    tasks_mod = types.ModuleType("mjlab.tasks")
    tasks_mod.registry = registry_mod
    root = types.ModuleType("mjlab")
    root.env, root.envs, root.tasks = env_mod, envs_mod, tasks_mod
    for name, mod in {"mjlab": root, "mjlab.env": env_mod, "mjlab.envs": envs_mod, "mjlab.tasks": tasks_mod,
                      "mjlab.tasks.registry": registry_mod}.items():
        monkeypatch.setitem(sys.modules, name, mod)


def test_make_mjlab_env_matches_jax_with_fake_modules(monkeypatch):
    results = []
    for make, make_config, adapter in ((make_mjlab_env, make_mjlab_env_config, MjlabEnvAdapter),
                                       (jax_make_mjlab_env, jax_make_mjlab_env_config, JaxMjlabEnvAdapter)):
        created = {}
        _install_mjlab(monkeypatch, created)
        cfg = make_config("Mjlab-Velocity-Flat-Unitree-Go1", play=False)
        assert created["loaded"] == ("Mjlab-Velocity-Flat-Unitree-Go1", False)
        play_cfg = make_config("Mjlab-Velocity-Flat-Unitree-Go1", play=True)
        env = make("Mjlab-Velocity-Flat-Unitree-Go1", config=cfg, device="cpu")
        assert isinstance(env, adapter) and created["kwargs"] == {"device": "cpu"} and created["cfg"] is cfg
        made = make("Mjlab-Velocity-Flat-Unitree-Go1", play=True)  # the configuration from the registry
        assert created["loaded"] == ("Mjlab-Velocity-Flat-Unitree-Go1", True) and made.num_instances == 4
        results.append((dataclasses.asdict(cfg), dataclasses.asdict(play_cfg), env.num_instances))
    assert results[0] == results[1]
    assert results[0][0] == {"episode_length_s": 3.0, "decimation": 2, "device": None}
    assert results[0][1]["viewer_type"] == "viser" and results[0][1]["viser_port"] == 8080


class _PersistentBufferSim(FakeSimEnv):
    """``FakeSimEnv`` returning the same tensors every step, rewritten in
    place, as IsaacLab's ``ManagerBasedRLEnv`` returns its ``obs_buf``,
    ``reward_buf``, ``reset_terminated`` and ``reset_time_outs`` (and mjlab's
    after it); ``returned`` keeps copies of each step's values, taken then."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.buffers = {}
        self.returned = []

    def _persist(self, name, value):
        buffer = self.buffers.setdefault(name, torch.empty_like(value))
        return buffer.copy_(value)

    def _obs(self):
        return {k: self._persist(k, v) for k, v in super()._obs().items()}

    def step(self, action):
        obs, *out, extras = super().step(action)
        out = [self._persist(name, v) for name, v in zip(("reward", "terminated", "truncated"), out)]
        self.returned.append({"next_observation": obs["policy"].clone(), **{
            name: v.clone() for name, v in zip(("reward", "terminated", "truncated"), out)}})
        return (obs, *out, extras)


@pytest.mark.parametrize("kind", list(ADAPTERS))
def test_rollout_keeps_every_step_of_a_simulator_that_rewrites_its_buffers(kind):
    """Two iterations on a simulator that rewrites its returned buffers in
    place: the agent's rollout holds each step's own values, and the metrics
    and episode statistics are those of the same simulator allocating fresh
    tensors, bit for bit."""
    _, tf = _small_ppo()
    runs = []
    for fake in (_PersistentBufferSim(seed=4), _fake(seed=4)):
        trainer = Trainer(ADAPTERS[kind][0](fake), tf, num_iterations=2, verbose=False, device="cpu", seed=5)
        runs.append(([trainer.rollout_and_update() for _ in range(2)], trainer))
    (rows, trainer), (fresh_rows, fresh) = runs
    assert rows == fresh_rows
    assert trainer.stats.summary() == fresh.stats.summary() and trainer.stats.episode_count > 0
    data, returned = trainer.agent.buffer.data, trainer.environment.wrapped.returned[-8:]
    for key in returned[0]:
        want = torch.stack([step[key].reshape(8, -1) for step in returned])
        assert torch.equal(data[key].reshape(want.shape).to(want.dtype), want), key
        assert torch.equal(data[key], fresh.agent.buffer.data[key]), key


class _NumpyAdapter(IsaacLabEnvAdapter):
    """The port's adapter with numpy arrays out, as a host simulator's: the
    Trainer's numpy loop."""

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        obs, state, extras = super().reset()
        return obs.numpy(), None if state is None else state.numpy(), extras

    def step(self, action):
        return tuple(x.numpy() if isinstance(x, torch.Tensor) else x for x in super().step(action))


class _TensorDummy(DummyEnvironment):
    """``DummyEnvironment`` (no autoreset) with tensors out: the tensor loop's
    resets by index."""

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        obs, state, info = super().reset(indices)
        return torch.from_numpy(obs), torch.from_numpy(state), info

    def step(self, action):
        return tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in super().step(action))


ENVIRONMENTS = {  # (tensors out, numpy out)
    "autoreset": (lambda: IsaacLabEnvAdapter(_fake(seed=4)), lambda: _NumpyAdapter(_fake(seed=4))),
    "reset_by_index": (lambda: _TensorDummy(observation_dim=6, action_dim=3, num_instances=8, state_dim=9, seed=4),
                       lambda: DummyEnvironment(observation_dim=6, action_dim=3, num_instances=8, state_dim=9, seed=4)),
}


@pytest.mark.parametrize("environment", list(ENVIRONMENTS))
def test_tensor_host_loop_gives_the_numpy_loops_metrics(environment):
    """Three iterations of the port's host loop on an environment's tensors
    and on the same environment's numpy arrays (the simulator adapter, which
    autoresets; ``DummyEnvironment``, reset by index): the same metrics, bit
    for bit, and the same episode statistics (fp64 sums, summed in another
    order)."""
    _, tf = _small_ppo()
    runs = []
    for make in ENVIRONMENTS[environment]:
        trainer = Trainer(make(), tf, num_iterations=3, verbose=False, device="cpu", seed=5)
        rows = [trainer.rollout_and_update() for _ in range(3)]
        runs.append((rows, trainer))
    (rows, trainer), (numpy_rows, numpy_trainer) = runs
    assert isinstance(trainer._host_obs, torch.Tensor) and isinstance(numpy_trainer._host_obs, np.ndarray)
    assert rows == numpy_rows
    assert trainer.stats.episode_count == numpy_trainer.stats.episode_count > 0
    assert trainer.stats.total_steps == numpy_trainer.stats.total_steps == 3 * 8 * 8
    assert trainer.stats.summary() == pytest.approx(numpy_trainer.stats.summary(), rel=1e-12)
    for a, b in zip(trainer.agent.model.parameters(), numpy_trainer.agent.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("environment", list(ENVIRONMENTS))
def test_player_tensor_loop_gives_the_numpy_loops_summary(environment):
    """The Player's loop on an environment's tensors and on its numpy arrays,
    40 deterministic steps from the same weights: the same summary (the
    simulator's metrics and, where episodes end, their statistics)."""
    _, tf = _small_ppo()
    summaries = []
    for make in ENVIRONMENTS[environment]:
        player = Player(make(), tf, num_steps=40, timestep=0, verbose=False, device="cpu", seed=5)
        summaries.append(player.run_playing_loop())
    summary, numpy_summary = summaries
    assert set(summary) == set(numpy_summary) and "episode_reward" in summary
    assert summary == pytest.approx(numpy_summary, rel=1e-6)


def test_log_iteration_logs_the_environment_metrics_as_jax():
    jf, tf = _small_ppo()
    trainer = Trainer(IsaacLabEnvAdapter(_fake()), tf, num_iterations=1, verbose=False, device="cpu")
    jax_trainer = JaxTrainer(JaxIsaacLabEnvAdapter(_fake()), jf, num_iterations=1, verbose=False)
    infos = []
    for t, action in ((trainer, torch.zeros(8, 3)), (jax_trainer, np.zeros((8, 3), np.float32))):
        t.environment.reset()
        t.environment.step(action)
        infos.append({k: v for k, v in t._log_iteration(0, {}).items() if k.startswith("Environment/")})
    info, jax_info = infos
    assert info == pytest.approx(jax_info, rel=1e-7)
    assert info == {"Environment/Episode_Reward/tracking": 1.0, "Environment/Metrics/feet_air": 2.0}


@pytest.mark.parametrize("compute_dtype", ["bfloat16", None], ids=["bf16", "fp32"])
def test_anymal_c_iteration_matches_jax(monkeypatch, compute_dtype):
    """One host-loop iteration of ``Isaac-Velocity-Rough-Anymal-C-v0``/``ppo``
    (24 steps, 5 x 4 minibatches, KL-adaptive lr, entropy 0.005) cut to
    hidden (32, 16) and 16 environments at the uncut 235/12 widths, through
    the JAX Trainer and the port's: the JAX agent's weights, its actions
    replayed, its minibatch plan; in the entry's bf16 and in fp32."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: x.dim() >= 2 and all(
        l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers))
    jf, tf = jax_get_experiment(*ANYMAL).make_agent_factory(), get_experiment(*ANYMAL).make_agent_factory()
    for f in (jf, tf):
        f.actor_hidden_dims = f.critic_hidden_dims = (32, 16)

    def fake():
        return _fake(critic=False, num_envs=ANYMAL_ENVS, obs_dim=ANYMAL_OBS, state_dim=1, act_dim=ANYMAL_ACT, seed=7)

    jax_trainer = JaxTrainer(JaxIsaacLabEnvAdapter(fake()), jf, num_iterations=1, verbose=False)
    trainer = Trainer(IsaacLabEnvAdapter(fake()), tf, num_iterations=1, verbose=False, device="cpu")
    jax_agent, agent = jax_trainer.agent, trainer.agent
    assert (agent.num_steps_per_update, agent.parallelism, agent.sampler.num_epochs) == (24, ANYMAL_ENVS, 5)
    assert agent.environment_spec.state_dim is None and agent.environment_spec.observation_dim == ANYMAL_OBS
    assert [l.weight.shape[1] for l in agent.actor.backbone.layers] == [ANYMAL_OBS, 32]
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])

    captured = {}
    jax_update = jax_agent._get_update_jit()

    def spy(state, rollout, key, buffer_state):
        captured.update(rollout=rollout, key=key)
        return jax_update(state, rollout, key, buffer_state)

    jax_agent._update_jit = spy
    jax_metrics = jax_trainer._rollout_and_update()
    rollout = captured["rollout"]
    _, perms, _ = jax_agent.sampler.make_epoch_plan(captured["key"], 24, ANYMAL_ENVS, rollout)

    replay = list(np.asarray(rollout["action"]))
    distribution = agent.actor.distribution
    distribution.sample = lambda params, generator=None, noise=None: (
        lambda action: (action, distribution.compute_logp(params, action)))(torch.from_numpy(replay.pop(0)))
    update_body = agent.update_body
    agent.update_body = lambda rollout, epoch_perms=None, buffer_state=None: update_body(
        rollout, np.asarray(perms), buffer_state)
    reset_launch_counts()
    metrics = trainer.rollout_and_update()
    assert not replay and not any(LAUNCHES.values())  # the plain versions on the CPU
    data = agent.buffer.data
    for key in ("observation", "next_observation", "action", "terminated", "truncated", "reward"):
        np.testing.assert_array_equal(data[key].numpy(), np.asarray(rollout[key]), err_msg=key)
    assert data["observation"].shape == (24, ANYMAL_ENVS, ANYMAL_OBS) and bool(data["terminated"].any())
    assert set(metrics) == set(jax_metrics)
    for key in metrics:
        tol = (DIFFERENCE_TOL if key in DIFFERENCE_METRICS else METRIC_TOL)[compute_dtype]
        np.testing.assert_allclose(metrics[key], float(jax_metrics[key]), err_msg=key, **tol)
    assert trainer.stats.total_steps == jax_trainer.stats.total_steps == 24 * ANYMAL_ENVS
    assert trainer.stats.summary() == pytest.approx(jax_trainer.stats.summary(), rel=1e-12)
    assert agent.iteration == jax_agent.iteration == 1
