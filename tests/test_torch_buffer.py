"""The host loop's data structures against the JAX package's, on the CPU:
``Buffer`` (a partly filled ring, a wrapped one, a resize, the mapping
interface), the random samplers under ``buffer_state``, the categorical
policy (``OneHotCategoricalDist``: sampling with the same Gumbel draws,
logp, entropy, KL, mode and the straight-through gradient, fp32 within
1e-6) and the environment helpers (``get_done_indices``,
``update_observation_and_state``).  Inputs are numpy arrays from a seed; the
buffers and plans are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.module.distribution import OneHotCategoricalDistFactory as JaxCategoricalFactory
from cusrl_tpu.sampler.random_sampler import RandomSampler as JaxRandomSampler
from cusrl_tpu.sampler.random_sampler import TemporalRandomSampler as JaxTemporalRandomSampler
from cusrl_tpu.template.buffer import Buffer as JaxBuffer
from cusrl_tpu.template.environment import get_done_indices as jax_get_done_indices
from cusrl_tpu.template.environment import update_observation_and_state as jax_update_observation_and_state
from cusrl_tpu_torch.nn.module.distribution import OneHotCategoricalDistFactory
from cusrl_tpu_torch.preset.ppo import get_distribution_factory
from cusrl_tpu_torch.sampler.random_sampler import RandomSampler, TemporalRandomSampler
from cusrl_tpu_torch.template.buffer import Buffer, Sampler
from cusrl_tpu_torch.template.environment import get_done_indices, update_observation_and_state

CAPACITY, N = 4, 3


def _step(rng):
    return {
        "observation": rng.standard_normal((N, 2)).astype(np.float32),
        "action_dist": {"logits": rng.standard_normal((N, 2)).astype(np.float32)},
        "done": rng.random((N, 1)) < 0.3,
    }


def _assert_same(buffer, jax_buffer):
    assert (buffer.cursor, buffer.full, buffer.num_valid_steps) == (
        jax_buffer.cursor, jax_buffer.full, jax_buffer.num_valid_steps)
    assert list(buffer) == list(jax_buffer) and len(buffer) == len(jax_buffer)
    data, jax_data = buffer.data, jax_buffer.data
    flat = dict(_leaves(data))
    jax_flat = dict(_leaves(jax_data))
    assert flat.keys() == jax_flat.keys()
    for key, value in flat.items():
        assert value.dtype == torch.from_numpy(np.array(jax_flat[key])).dtype, key
        np.testing.assert_array_equal(value.numpy(), np.asarray(jax_flat[key]), err_msg=key)


def _leaves(nest, prefix=""):
    if isinstance(nest, dict):
        for key, value in nest.items():
            yield from _leaves(value, f"{prefix}.{key}" if prefix else key)
    else:
        yield prefix, nest


@pytest.mark.parametrize("steps", [2, 4, 6])
def test_buffer_matches_jax_through_the_ring(steps):
    """2 steps: partly filled; 4: one whole rollout (one stack per field);
    6: wrapped, the first two slots overwritten."""
    rng = np.random.default_rng(steps)
    buffer, jax_buffer = Buffer(CAPACITY, N, "cpu"), JaxBuffer(CAPACITY, N)
    for _ in range(steps):
        step = _step(rng)
        buffer.push(step)
        jax_buffer.push(step)
    _assert_same(buffer, jax_buffer)
    # Read, push more, read again: what was read before stays as it was.
    before = buffer["observation"].clone()
    first = buffer["observation"]
    step = _step(rng)
    buffer.push(step)
    jax_buffer.push(step)
    np.testing.assert_array_equal(first.numpy(), before.numpy())
    _assert_same(buffer, jax_buffer)


def test_buffer_mapping_interface_resize_and_replace_match_jax():
    rng = np.random.default_rng(1)
    buffer, jax_buffer = Buffer(CAPACITY, N, "cpu"), JaxBuffer(CAPACITY, N)
    value = rng.standard_normal((CAPACITY, N, 5)).astype(np.float32)
    nested = {"a": value, "b": {"c": value[..., :1]}}
    for b in (buffer, jax_buffer):
        b["value"] = value
        b["nested"] = nested
        b["skipped"] = None
    _assert_same(buffer, jax_buffer)
    assert "skipped" not in buffer and buffer.get("skipped", 7) == 7 == jax_buffer.get("skipped", 7)
    for b in (Buffer(CAPACITY, N, "cpu"), JaxBuffer(CAPACITY, N)):
        b["nested"] = nested
        with pytest.raises(ValueError, match="capacity=4"):
            b["bad"] = value[:2]
        with pytest.raises(ValueError, match="Schema mismatch"):
            b["nested"] = {"a": value}
        with pytest.raises(ValueError, match="parallelism=3"):
            b.push({"nested": {"a": value[0, :2], "b": {"c": value[0, :2, :1]}}})
    del buffer["nested"], jax_buffer["nested"]
    _assert_same(buffer, jax_buffer)
    mapped = buffer.sample(lambda key, x: x[:1])
    jax_mapped = jax_buffer.sample(lambda key, x: x[:1])
    np.testing.assert_array_equal(mapped["value"].numpy(), np.asarray(jax_mapped["value"]))
    (metadata, whole), = list(Sampler()(buffer))
    assert metadata == {} and set(whole) == {"value"}
    step = _step(rng)
    for b in (buffer, jax_buffer):
        b.push(step)
        b.reset_cursor()
    _assert_same(buffer, jax_buffer)
    for b in (buffer, jax_buffer):
        b.resize(CAPACITY + 2)
    assert buffer.capacity == jax_buffer.capacity == CAPACITY + 2 and len(buffer) == 0 == len(jax_buffer)
    rollout = {"observation": rng.standard_normal((CAPACITY + 2, N, 2)).astype(np.float32),
               "action_dist": {"logits": rng.standard_normal((CAPACITY + 2, N, 2)).astype(np.float32)}}
    for b in (buffer, jax_buffer):
        b.replace_data(rollout)
    _assert_same(buffer, jax_buffer)


RING_STATES = [{"cursor": 3, "full": False}, {"cursor": 5, "full": True}, {"cursor": 0, "full": True}]
T_RING, N_RING = 8, 4


@pytest.mark.parametrize("buffer_state", RING_STATES, ids=["partly_filled", "wrapped", "full"])
def test_random_sampler_plans_follow_buffer_state_like_jax(buffer_state):
    """The JAX plan under ``buffer_state``, injected, gathers the JAX rows;
    the port's own draws lie in the valid region."""
    rng = np.random.default_rng(2)
    rollout = {"observation": rng.standard_normal((T_RING, N_RING, 3)).astype(np.float32)}
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    torch_rollout = {"observation": torch.from_numpy(rollout["observation"])}
    valid = T_RING if buffer_state["full"] else buffer_state["cursor"]
    generator = torch.Generator().manual_seed(0)

    sampler, jax_sampler = RandomSampler(4, 16), JaxRandomSampler(4, 16)
    _, _, indices = jax_sampler.make_plan(jax.random.key(3), T_RING, N_RING, jax_rollout, buffer_state)
    plan = sampler.make_epoch_plan(T_RING, N_RING, plan=np.asarray(indices), buffer_state=buffer_state)
    for k in range(4):
        got = sampler.gather(sampler.source(torch_rollout), plan, 0, k)["observation"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sampler.gather(jax_rollout, indices[k])["observation"]))
    drawn = sampler.make_epoch_plan(T_RING, N_RING, generator, buffer_state=buffer_state).indices
    assert int(drawn.min()) >= 0 and int(drawn.max()) < valid * N_RING

    length = 3
    sampler, jax_sampler = TemporalRandomSampler(4, 5, length), JaxTemporalRandomSampler(4, 5, length)
    _, _, (time_idx, env_idx) = jax_sampler.make_plan(jax.random.key(4), T_RING, N_RING, jax_rollout, buffer_state)
    plan = sampler.make_epoch_plan(T_RING, N_RING, plan=(np.asarray(time_idx), np.asarray(env_idx)),
                                   buffer_state=buffer_state)
    for k in range(4):
        got = sampler.gather(torch_rollout, plan, 0, k)["observation"]
        want = jax_sampler.gather(jax_rollout, (time_idx[k], env_idx[k]))["observation"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    time_drawn, env_drawn = sampler.make_epoch_plan(T_RING, N_RING, generator, buffer_state=buffer_state).indices
    logical = (time_drawn - (buffer_state["cursor"] if buffer_state["full"] else 0)) % T_RING
    assert int(logical.max()) < valid and int(env_drawn.max()) < N_RING
    assert (logical[:, 1:] - logical[:, :-1] == 1).all()  # each window runs forward in logical time


def _categorical_pair(seed=0):
    key = jax.random.key(seed)
    jax_dist = JaxCategoricalFactory()(8, 3, key)
    dist = OneHotCategoricalDistFactory()(8, 3)
    with torch.no_grad():
        dist.mean_head.weight.copy_(torch.from_numpy(np.asarray(jax_dist.mean_head.weight)))
        dist.mean_head.bias.copy_(torch.from_numpy(np.asarray(jax_dist.mean_head.bias)))
    return jax_dist, dist


FP32 = dict(rtol=0, atol=1e-6)


def test_one_hot_categorical_matches_jax():
    jax_dist, dist = _categorical_pair()
    assert isinstance(get_distribution_factory("discrete", init_std=0.5), OneHotCategoricalDistFactory)
    with pytest.raises(ValueError, match="Unsupported"):
        get_distribution_factory("multi")
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((64, 8)).astype(np.float32)
    other = rng.standard_normal((64, 8)).astype(np.float32)
    jax_p, jax_q = jax_dist(jnp.asarray(feat)), jax_dist(jnp.asarray(other))
    p, q = dist(torch.from_numpy(feat)), dist(torch.from_numpy(other))
    np.testing.assert_allclose(p["logits"].detach().numpy(), np.asarray(jax_p["logits"]), **FP32)
    key = jax.random.key(9)
    gumbel = np.asarray(jax.random.gumbel(key, jax_p["logits"].shape, jnp.float32))
    jax_action, jax_logp = jax_dist.sample(jax_p, key)
    action, logp = dist.sample(p, noise=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(action.detach().numpy(), np.asarray(jax_action))
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jax_logp), **FP32)
    pairs = [
        (dist.compute_logp(p, action), jax_dist.compute_logp(jax_p, jax_action)),
        (dist.compute_entropy(p), jax_dist.compute_entropy(jax_p)),
        (dist.compute_kl_div(p, q), jax_dist.compute_kl_div(jax_p, jax_q)),
        (dist.mode(p), jax_dist.mode(jax_p)),
        (dist.determine(torch.from_numpy(feat)), jax_dist.determine(jnp.asarray(feat))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)
    assert set(np.unique(dist.mode(p).numpy())) == {0.0, 1.0} and (dist.mode(p).sum(-1) == 1).all()
    # Draws from the generator: one-hot, and each class drawn about as often as its probability says.
    drawn, _ = dist.sample({"logits": torch.zeros(20000, 3)}, torch.Generator().manual_seed(0))
    assert (drawn.sum(-1) == 1).all() and (drawn.mean(0) - 1 / 3).abs().max() < 0.02


def test_one_hot_categorical_straight_through_gradient_matches_jax():
    """d/dlogits of ``sum(action * c) + sum(logp)``: the softmax's Jacobian
    through the straight-through estimator, and log-softmax's."""
    jax_dist, dist = _categorical_pair(1)
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((32, 3)).astype(np.float32)
    weight = rng.standard_normal((32, 3)).astype(np.float32)
    key = jax.random.key(2)
    gumbel = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))

    def jax_objective(l):
        action, logp = jax_dist.sample({"logits": l}, key)
        return jnp.sum(action * weight) + jnp.sum(logp)

    jax_grad = jax.grad(jax_objective)(jnp.asarray(logits))
    t_logits = torch.from_numpy(logits).requires_grad_()
    action, logp = dist.sample({"logits": t_logits}, noise=torch.from_numpy(gumbel))
    (torch.sum(action * torch.from_numpy(weight)) + torch.sum(logp)).backward()
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(jax_grad), **FP32)


def test_environment_helpers_match_jax():
    rng = np.random.default_rng(4)
    terminated, truncated = rng.random((6, 1)) < 0.3, rng.random((6, 1)) < 0.3
    indices = get_done_indices(terminated, truncated)
    np.testing.assert_array_equal(indices, jax_get_done_indices(terminated, truncated))
    obs, new_obs = rng.standard_normal((6, 3)), rng.standard_normal((6, 3))
    state, new_state = rng.standard_normal((6, 2)), rng.standard_normal((6, 2))
    for with_state in (True, False):
        got = update_observation_and_state(obs, state if with_state else None, new_obs, new_state, indices)
        want = jax_update_observation_and_state(obs, state if with_state else None, new_obs, new_state, indices)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) and (got[1] is None or np.array_equal(got[1], want[1]))
    assert not np.shares_memory(got[0], obs)
