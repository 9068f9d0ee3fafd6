"""The zoo's ``Velocity-Flat``/``transformer_ppo`` entry in the port, against
the JAX package, on the CPU, at small widths (embed 32, 2 heads, window 4,
T = 8, N = 512: four 128-environment tiles, so the sampler's tile
permutation is in play).

One whole update: the port takes the JAX agent's weights, its hook state
(observation statistics, the adaptive learning rate's accumulators and the
critic's ring memory) and its actor memory through ``load_jax_state``; both
update on the same injected rollout (made with numpy from a seed, with dones
mid-rollout, actions sampled from the JAX actor in sequence mode) and the same
environment permutation, taken from the JAX sampler's plan.  The port runs
the kernels' plain versions: lane attention (K3) in every sequence pass, the
next-token attention (K6) in the bootstrap pass and, in bf16, the head's
fused chain (K1) with the rule of ``_can_fuse`` read without "on CUDA".  The
FFN stays on the modular chain here: the JAX package's CPU route computes
gelu op by op in bf16 where its kernel (and K1 with gelu) computes it in fp32
on the bf16 pre-activation, a rounding apart on about 40 % of the elements;
K1's gelu is held to the JAX kernel in tests/test_torch_fused_mlp.py and
tests/test_torch_transformer.py.  Tolerances as
tests/test_torch_update_zoo.py: fp32 to summation order, bf16 to one rounding
carried through 20 Adam steps.

Then a few Trainer iterations of the entry: chunked and unchunked runs give
the same metrics, one host transfer per chunk, and the rollout records only
its initial memories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.nn.base import storable_memory as jax_storable_memory
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.nn.module.causal_attn import CausalMultiheadSelfAttention
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.preset.ppo import ppo_hook_suite
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

T, N, OBS, ACT = 8, 512, 10, 3
SMALL = dict(num_steps_per_update=T, embed_dim=32, num_heads=2, attention_window=4, mlp_hidden_dims=(32,))
# Parameters in fp32: Adam scales each step by the gradient's own RMS, so
# summation noise on a near-zero gradient element reaches the full lr
# (1e-3) scale; measured up to 2.2e-6 after 20 steps (the MLP test: 2e-6).
FP32_TOL = (dict(rtol=1e-5, atol=5e-6), dict(rtol=0, atol=1e-5), dict(rtol=1e-4, atol=1e-4))
# bf16: every module's forward and gradient is within one bf16 rounding of
# JAX's on the same inputs (tests/test_torch_transformer.py), and the whole
# networks' gradients differ by flipped bf16 roundings where the two sides
# round (gelu, elu) or sum in another order; 20 Adam steps carry that into
# the KL and the importance-weighted advantage, small differences of nearly
# equal terms.  The MLP test's 1e-3 holds every other metric.  Parameters:
# Adam moves an element with a near-zero gradient by up to lr (1e-3) per
# step whatever the gradient's size, so a flipped rounding there shows at
# full step size (the MLP test's 3e-3 holds it).
BF16_TOL = (dict(rtol=1e-3, atol=1e-4), dict(rtol=0, atol=5e-3), dict(rtol=1e-3, atol=2e-3))
BF16_DIFFERENCE_METRICS = ("kl_divergence", "importance_weighted_advantage", "ratio", "surrogate_loss")
RING_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 ring entries: one rounding of values of order 1


def test_zoo_transformer_entry_matches_jax():
    spec, ref = get_experiment("Velocity-Flat", "transformer_ppo"), jax_get_experiment("Velocity-Flat",
                                                                                      "transformer_ppo")
    assert spec.agent_meta_factory_kwargs == ref.agent_meta_factory_kwargs
    assert spec.training_env_factory_kwargs == ref.training_env_factory_kwargs == {"num_instances": 1024}
    assert spec.benchmarking_env_factory_kwargs == ref.benchmarking_env_factory_kwargs
    for name in ("num_iterations", "checkpoint_interval", "iterations_per_dispatch", "experiment_name"):
        assert getattr(spec, name) == getattr(ref, name), name
    factory = spec.to_training_factory()
    factory.environment_kwargs = {"num_instances": 8}
    trainer = factory(device="cpu", verbose=False)
    backbone = trainer.agent.actor.backbone
    layer = backbone.members[0]
    assert layer.attention.mha.num_heads == 4 and layer.attention.window == 16 and layer.output_dim == 128
    assert layer.feed_forward.up.output_dim == 512 and layer.feed_forward.activation == "gelu"
    assert [l.output_dim for l in backbone.members[1].layers] == [128]
    assert trainer.agent.get_hook("value_computation").deferred == "sequential"
    from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite

    kwargs = {k: v for k, v in spec.agent_meta_factory_kwargs.items()
              if k in ("normalize_observation", "desired_kl_divergence")}
    assert [h.hook_name for h in trainer.agent.hooks] == [h.hook_name for h in jax_suite(**kwargs)]


def test_recurrent_suite_builds_the_joint_evaluation():
    from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite

    kwargs = dict(recurrent_backbones=True, fuse_actor_critic_evaluation=True)
    assert [h.hook_name for h in ppo_hook_suite(**kwargs)] == [h.hook_name for h in jax_suite(**kwargs)]
    assert "joint_sequential_evaluation" not in [h.hook_name for h in ppo_hook_suite(recurrent_backbones=True)]


def _kernel_routes(monkeypatch, bf16: bool):
    """The kernels' routes on the CPU (their plain versions run)."""
    resolve = CausalMultiheadSelfAttention._resolve_mode
    monkeypatch.setattr(CausalMultiheadSelfAttention, "_resolve_mode",
                        lambda self, x, ctx: "lane" if self.sequence_mode == "auto" else resolve(self, x, ctx))
    if bf16:
        monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: x.dim() >= 2 and all(
            l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers))


def _factories(t_len=T, **overrides):
    jf = jax_get_experiment("Velocity-Flat", "transformer_ppo").make_agent_factory()
    tf = get_experiment("Velocity-Flat", "transformer_ppo").make_agent_factory()
    for f in (jf, tf):
        for k, v in {**SMALL, "num_steps_per_update": t_len, **overrides}.items():
            setattr(f, k, v)
    return jf, tf


def _warm_memories(jax_agent, rng, n=N):
    """Part-full rings (cursor 3, some slots reset) for the actor and the
    critic's ValueComputation, from three steps on random inputs."""
    actor, critic = jax_agent.state.actor, jax_agent.state.critic
    a_mem, c_mem = actor.init_memory(n), critic.init_memory(n)
    from cusrl_tpu.nn.base import reset_memory

    for _ in range(3):
        x = jnp.asarray(rng.standard_normal((n, OBS)), jnp.float32)
        _, a_mem, _ = actor(x, a_mem)
        _, c_mem, _ = critic(x, c_mem)
        done = jnp.asarray(rng.random((n, 1)) < 0.2)
        a_mem, c_mem = reset_memory(a_mem, done), reset_memory(c_mem, done)
    jax_agent.actor_memory = a_mem
    hook = jax_agent.get_hook("value_computation")
    jax_agent.update_hook("value_computation", hook.replace(memory=c_mem))
    for index, h in enumerate(jax_agent.state.hooks):
        if h.hook_name == "observation_normalization":
            rms = h.observation_rms.replace(mean=jnp.asarray(rng.standard_normal(OBS), jnp.float32),
                                            var=jnp.asarray(rng.random(OBS) + 0.5, jnp.float32),
                                            count=jnp.asarray(300.0, jnp.float32))
            jax_agent.update_hook(h.hook_name, h.replace(observation_rms=rms))
        elif h.hook_name == "adaptive_l_r_schedule":
            jax_agent.update_hook(h.hook_name, h.replace(lr_scale=jnp.asarray(0.7, jnp.float32)))


def _rollout(jax_agent, rng, t_len=T, n=N):
    obs = np.tanh(rng.standard_normal((t_len, n, OBS))).astype(np.float32)
    next_obs = np.concatenate([obs[1:], np.tanh(rng.standard_normal((1, n, OBS)))], 0).astype(np.float32)
    terminated = rng.random((t_len, n, 1)) < 0.05
    truncated = rng.random((t_len, n, 1)) < 0.05
    done = terminated | truncated
    next_obs = np.where(done, np.tanh(rng.standard_normal((t_len, n, OBS))).astype(np.float32), next_obs)
    actor = jax_agent.state.actor
    dist, _, _ = actor(jnp.asarray(obs), jax_agent.actor_memory, sequential=True, done=jnp.asarray(done))
    action = dist["mean"] + dist["std"] * rng.standard_normal((t_len, n, ACT)).astype(np.float32)
    critic_memory = jax_agent.get_hook("value_computation").memory
    return {
        "observation": obs,
        "next_observation": next_obs,
        "action": np.asarray(action),
        "action_logp": np.asarray(actor.compute_logp(dist, action)),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((t_len, n, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated,
        "done": done,
        "actor_memory": jax.tree.map(lambda m: np.asarray(m)[None],
                                     jax_storable_memory(jax_agent.actor_memory, n)),
        "critic_memory": jax.tree.map(lambda m: np.asarray(m)[None], jax_storable_memory(critic_memory, n)),
    }


def _to_torch(tree):
    def convert(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    return jax.tree.map(convert, tree)


def _tile_perms(indices, epochs, tiled=True):
    """The JAX temporal plan's ``[E*M, B]`` environment indices (runs of 128
    consecutive environments) as the port's ``[E, N/128]`` tile permutation;
    with ``tiled=False`` (fewer than 128 environments per minibatch) as the
    ``[E, N]`` environment permutation."""
    order = np.asarray(indices).reshape(epochs, -1)
    if not tiled:
        return order
    assert (order.reshape(epochs, -1, 128) == order[:, ::128, None] + np.arange(128)).all()
    return order[:, ::128] // 128


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_transformer_update_matches_jax(compute_dtype, monkeypatch):
    _update_matches_jax(compute_dtype, monkeypatch)


@pytest.mark.parametrize("fuse_actor_critic_evaluation", [False, True])
def test_transformer_update_on_the_fused_route_matches_jax(fuse_actor_critic_evaluation, monkeypatch):
    """The same update on the fused-block route (``CUSRL_TPU_FUSED_TRANSFORMER
    =force`` on both sides: the port's K4 plain versions, JAX's Pallas
    kernels in interpret mode), with and without the joint evaluation (K5 and
    the tails' pair chain with input gradients, K2's plain version, in the
    port; the Pallas pair kernels in JAX)."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    _update_matches_jax("bfloat16", monkeypatch, fuse_actor_critic_evaluation=fuse_actor_critic_evaluation)


def _update_matches_jax(compute_dtype, monkeypatch, t_len=T, n=N, **factory_kwargs):
    """One update on both sides (``t_len`` steps of ``n`` environments)."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    _kernel_routes(monkeypatch, compute_dtype is not None)
    jf, tf = _factories(t_len, **factory_kwargs)
    jax_agent = jf(JaxEnv(num_instances=n, observation_dim=OBS, action_dim=ACT).spec)
    agent = tf(VelocityLocomotionEnv(num_instances=n, observation_dim=OBS, action_dim=ACT, device="cpu").spec,
               device="cpu")
    rng = np.random.default_rng(7)
    _warm_memories(jax_agent, rng, n)
    state = jax_agent.state_dict()
    load_jax_state(agent, state["agent_state"], actor_memory=state["actor_memory"])

    rollout = _rollout(jax_agent, rng, t_len, n)
    key = jax.random.key(5)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    _, _, indices = jax_agent.sampler.make_plan(key, t_len, n, jax_rollout)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    epochs = jax_agent.sampler.num_epochs
    count = jax_agent.sampler.num_mini_batches
    tiled = n % 128 == 0 and (n // count) % 128 == 0 and n // 128 >= count  # the samplers' "auto" tiles
    metrics = agent.update_body(_to_torch(rollout), epoch_perms=_tile_perms(indices, epochs, tiled))

    metric_tol, param_tol, state_tol = FP32_TOL if compute_dtype is None else BF16_TOL
    assert set(metrics) == set(jax_metrics)
    for name, value in jax_metrics.items():
        tol = dict(rtol=2e-2, atol=1e-4) if compute_dtype and name in BF16_DIFFERENCE_METRICS else metric_tol
        np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=name, **tol)
    new = {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic.",
                                                                                            "hooks."))}
    params = dict(agent.model.named_parameters())
    assert set(params) == {p for p in new if not p.startswith("hooks.")}
    for path, param in params.items():
        np.testing.assert_allclose(param.detach().numpy(), new[path], err_msg=path, **param_tol)
    checked = set()
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            tol = state_tol
            if compute_dtype and name.endswith(("k_cache", "v_cache")):
                tol = RING_TOL
            elif compute_dtype and name == "accumulated_log_error":  # log(KL): the KL's relative error
                tol = dict(rtol=0, atol=2e-2)
            np.testing.assert_allclose(tensor.float().numpy(), new[f"hooks.{index}.{name}"], err_msg=name, **tol)
            checked.add(f"{hook.hook_name}.{name}")
    # The critic's ring after the value pass: final memory, reset by the last dones.
    assert {"value_computation.memory.0.k_cache", "value_computation.memory.0.cursor"} <= checked


def _trainer(iterations_per_dispatch, iterations=4):
    factory = get_experiment("Velocity-Flat", "transformer_ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": 16}
    for k, v in dict(SMALL, num_steps_per_update=6, embed_dim=16, mlp_hidden_dims=(16,)).items():
        setattr(factory.agent, k, v)
    factory.num_iterations, factory.checkpoint_interval = iterations, 50
    factory.iterations_per_dispatch = iterations_per_dispatch
    return factory(device="cpu", verbose=False, seed=3)


def test_trainer_chunks_the_transformer_entry():
    """Chunks of 3 (then 1) give the same per-iteration metrics as single
    iterations: the actor's and the critic's memories carry over from chunk to
    chunk; one host transfer per chunk; every metric finite."""
    chunked, single = _trainer(3), _trainer(1)
    rows = [chunked.rollout_and_update() for _ in range(4)]
    ref = [single.rollout_and_update() for _ in range(4)]
    assert chunked.host_transfers == 2 and single.host_transfers == 4
    for a, b in zip(rows, ref):
        assert set(a) == set(b) and "kl_divergence" in a and "value_loss" in a
        for name in a:
            assert np.isfinite(a[name])
            np.testing.assert_allclose(a[name], b[name], rtol=1e-5, atol=1e-6, err_msg=name)
    memory = chunked.agent.actor_memory["0"]
    assert int(memory["cursor"]) == 4 * 6 % 5 and memory["k_cache"].shape == (16, 2, 5, 8)


def test_rollout_records_only_the_initial_memories():
    trainer = _trainer(1)
    agent, driver = trainer.agent, trainer.driver
    driver._ensure_initialized()
    before = {k: v["0"]["k_cache"].clone() for k, v in agent.rollout_memory_entries().items()}
    rollout, _ = driver.collect(6)
    memory_keys = sorted(k for k in rollout if k.endswith("memory"))
    assert memory_keys == ["actor_memory", "critic_memory"]
    for key in memory_keys:
        assert rollout[key]["0"]["k_cache"].shape == (1, 16, 2, 5, 8)
        assert rollout[key]["0"]["cursor"].shape == (1, 16)
        torch.testing.assert_close(rollout[key]["0"]["k_cache"][0], before[key], rtol=0, atol=0)
    assert rollout["observation"].shape[:2] == (6, 16)
