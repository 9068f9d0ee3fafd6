"""The PPO path's remaining options in the port against the JAX package, at
small size: the sigmoid and softplus bijectors (specs, round trips, clamps
and the clamps' gradients), ``AdaptiveNormalDist`` (values and gradients,
with ``backward`` True and False), the minibatch-wise advantage
normalization, ``ValueComputation(sparse_bootstrap=True)`` against the full
pass and JAX's (at JAX's truncation rates, the overflow case among them),
the minibatch sampler's per-epoch counts, ``shuffle=False`` and explicit
``shuffle_block_size`` (plans, errors, the temporal gather), and one whole
update of path PO's configuration (the zoo's Velocity-Rough ``ppo`` at
widths 32-16 with all of them) on both sides.

Tolerances: the plans, the segments, the blocks and the scalar bijector
paths exactly; tensors in fp32 to 1e-6 (relative and absolute) where one
side's arithmetic is the other's, gradients summed over rows to 1e-5 of the
leaf's largest element, 1e-5 for the whole update (both sides in
fp32, ``tests/test_torch_aux_hooks.py``'s helpers); ``sparse_bootstrap``
equal to the full pass to 1e-6 (the critic on a subset of rows: the
matrix product may block the rows differently).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.on_policy.advantage import AdvantageNormalization as JaxAdvantageNormalization
from cusrl_tpu.hook.on_policy.fused_update import FusedPpoUpdate as JaxFusedPpoUpdate
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.layer import bijector as jax_bijector
from cusrl_tpu.nn.module.distribution import AdaptiveNormalDistFactory as JaxAdaptiveFactory
from cusrl_tpu.sampler.mini_batch_sampler import MiniBatchSampler as JaxMiniBatchSampler
from cusrl_tpu.sampler.mini_batch_sampler import TemporalMiniBatchSampler as JaxTemporalSampler
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageNormalization
from cusrl_tpu_torch.hook.on_policy.fused_update import FusedPpoUpdate
from cusrl_tpu_torch.nn.layer import bijector
from cusrl_tpu_torch.nn.module.distribution import AdaptiveNormalDist, AdaptiveNormalDistFactory
from cusrl_tpu_torch.sampler.mini_batch_sampler import MiniBatchSampler, TemporalMiniBatchSampler
from cusrl_tpu_torch.zoo.registry import get_experiment
from tests.test_torch_aux_hooks import N, SMALL, T, _t, build, compare, rollout_arrays

FP32 = dict(rtol=1e-6, atol=1e-6)
PO_EPOCHS = (4, 4, 4, 2, 2)  # path PO's minibatch counts, one per epoch


# -- the bijectors -------------------------------------------------------------------

BIJECTORS = {
    "exp": lambda m: m.ExponentialBijector(0.01, 1.0),
    "sigmoid": lambda m: m.SigmoidBijector(0.0, 1.0),
    "sigmoid_wide": lambda m: m.SigmoidBijector(-1.0, 2.0, 0.05),
    "softplus": lambda m: m.SoftplusBijector(1.0, 0.01, 1.0),
    "softplus_scaled": lambda m: m.SoftplusBijector(4.0, 0.05, 2.0),
}


def test_bijector_specs_match_jax():
    for spec in ("sigmoid", "sigmoid_0.0_2.0", "sigmoid_-1_1_0.1", "softplus", "softplus_2.0_0.05_3.0", "SoftPlus",
                 "exp_0.01_1.0", "identity", None):
        assert repr(bijector.make_bijector(spec)) == repr(jax_bijector.make_bijector(spec)).replace(
            "cusrl_tpu.", "cusrl_tpu_torch."), spec
    for make in (bijector.make_bijector, jax_bijector.make_bijector):
        with pytest.raises(ValueError, match="Unsupported bijector specification 'tanhspec'"):
            make("tanhspec")
    sig = bijector.make_bijector("sigmoid_0.0_2.0")
    assert isinstance(sig, bijector.SigmoidBijector) and sig.max_value == 2.0 and bijector.make_bijector(sig) is sig


@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_round_trip_clamps_and_gradients_match_jax(name):
    """Forward and inverse on values inside, outside and at the bounds,
    against JAX in fp32, the scalar path exactly (``math`` on both sides),
    the round trip inside the range (JAX's 1e-4), and the gradient of both
    directions (a clamp passes half the gradient at its bound, as
    ``jnp.clip`` does)."""
    ours, theirs = BIJECTORS[name](bijector), BIJECTORS[name](jax_bijector)
    xs = np.array([-100.0, -4.0, -1.0, -0.3, 0.0, 0.2, 0.7, 1.5, 3.0, 100.0], np.float32)
    ys = np.array([-1.0, 0.0, 0.01, 0.05, 0.2, 0.5, 0.9, 0.99, 1.0, 1.7, 2.0, 5.0], np.float32)
    ys = np.concatenate([ys, np.float32([getattr(theirs, "min_value", 0.0), getattr(theirs, "max_value", 1.0)])])
    for fn, values in (("__call__", xs), ("inverse", ys)):
        x = torch.tensor(values, requires_grad=True)
        out = getattr(ours, fn)(x)
        out.sum().backward()
        want, grad = jax.value_and_grad(lambda v: jnp.sum(getattr(theirs, fn)(v)))(jnp.asarray(values))
        want = np.asarray(getattr(theirs, fn)(jnp.asarray(values)))
        np.testing.assert_allclose(out.detach().numpy(), want, err_msg=fn, **FP32)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), err_msg=fn, rtol=1e-5, atol=1e-6)
    for y in (0.05, 0.2, 0.5, 0.9):
        assert ours.inverse(y) == theirs.inverse(y) and ours(ours.inverse(y)) == theirs(theirs.inverse(y))
    inside = torch.tensor([0.05, 0.2, 0.5, 0.9])
    if name in ("exp", "sigmoid", "softplus"):
        np.testing.assert_allclose(ours(ours.inverse(inside)).numpy(), inside.numpy(), rtol=1e-4, atol=1e-5)


# -- the adaptive Normal head --------------------------------------------------------


@pytest.mark.parametrize("backward", [True, False])
@pytest.mark.parametrize("spec", ["exp", "softplus"])
def test_adaptive_normal_dist_matches_jax(spec, backward):
    """The factory's initial std head (zero weights, the inverse of
    ``init_std`` as bias) and, with trained-looking weights carried over,
    the distribution's values, log-probability, entropy and KL, and the
    gradients of a loss on all of them with respect to the latent and both
    heads; with ``backward=False`` the std path adds nothing to the
    latent's gradient on either side."""
    jax_dist = JaxAdaptiveFactory(init_std=0.6, bijector=spec, backward=backward)(16, 4, jax.random.key(3))
    dist = AdaptiveNormalDistFactory(init_std=0.6, bijector=spec, backward=backward)(16, 4)
    assert isinstance(dist, AdaptiveNormalDist) and not dist.std_head.weight.any()
    np.testing.assert_allclose(dist.std_head.bias.detach().numpy(), np.asarray(jax_dist.std_head.bias), **FP32)
    rng = np.random.default_rng(0)
    weights = {f"{head}.{leaf}": rng.standard_normal(shape).astype(np.float32) * 0.3
               for head in ("mean_head", "std_head") for leaf, shape in (("weight", (4, 16)), ("bias", (4,)))}
    with torch.no_grad():
        for path, value in weights.items():
            dist.get_parameter(path).copy_(torch.from_numpy(value))
    jax_dist = jax_dist.replace(
        mean_head=jax_dist.mean_head.replace(weight=weights["mean_head.weight"], bias=weights["mean_head.bias"]),
        std_head=jax_dist.std_head.replace(weight=weights["std_head.weight"], bias=weights["std_head.bias"]))
    latent = rng.standard_normal((32, 16)).astype(np.float32)
    action = rng.standard_normal((32, 4)).astype(np.float32)
    old = {"mean": rng.standard_normal((32, 4)).astype(np.float32), "std": np.full((32, 4), 0.5, np.float32)}

    def loss_of(d, lat, logp, entropy, kl, xp):
        params = d(lat)
        return (xp.sum(logp(params)) + xp.sum(entropy(params)) + xp.sum(kl(params))
                + xp.sum(params["mean"] * params["std"])), params

    def jax_loss(d, lat):
        return loss_of(d, lat, lambda p: d.compute_logp(p, jnp.asarray(action)), d.compute_entropy,
                       lambda p: d.compute_kl_div(jax.tree.map(jnp.asarray, old), p), jnp)

    (want, want_params), (jax_grads, jax_latent_grad) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax_dist, jnp.asarray(latent))
    x = torch.tensor(latent, requires_grad=True)
    got, params = loss_of(dist, x, lambda p: dist.compute_logp(p, torch.from_numpy(action)), dist.compute_entropy,
                          lambda p: dist.compute_kl_div(jax.tree.map(torch.from_numpy, old), p), torch)
    got.backward()
    for key in ("mean", "std"):
        np.testing.assert_allclose(params[key].detach().numpy(), np.asarray(want_params[key]), err_msg=key, **FP32)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = {"latent": (x.grad, jax_latent_grad)}
    grads.update({f"{head}.{leaf}": (dist.get_parameter(f"{head}.{leaf}").grad,
                                     getattr(getattr(jax_grads, head), leaf))
                  for head in ("mean_head", "std_head") for leaf in ("weight", "bias")})
    for name, (got_grad, want_grad) in grads.items():  # fp32 sums over 32 rows: 1e-5 of the leaf's largest
        want_grad = np.asarray(want_grad)
        np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max(),
                                   err_msg=name)
    if not backward:  # the latent's gradient is the mean head's alone
        x2 = torch.tensor(latent, requires_grad=True)
        dist(x2)["std"].sum().backward()
        assert x2.grad is None


def test_fused_ppo_update_refuses_the_adaptive_head_with_jax_message(po_agents):
    """The joint evaluation keeps the heads outside the kernel for it (path
    PO); the fused update refuses it, with JAX's words."""
    jax_agent, agent = po_agents
    assert not agent.get_hook("joint_policy_value_evaluation").fuse_heads
    messages = []
    for hook, ag in ((FusedPpoUpdate(), agent), (JaxFusedPpoUpdate(), jax_agent)):
        with pytest.raises(ValueError) as error:
            hook.init(ag) if ag is agent else hook.init(ag, jax.random.key(0))
        messages.append(" ".join(str(error.value).split()))
    assert messages[0] == messages[1] and "got AdaptiveNormalDist" in messages[0]


# -- minibatch-wise advantage normalization -----------------------------------------


def test_minibatch_wise_advantage_normalization_matches_jax():
    """``pre_update`` leaves the rollout as it is; the objective standardizes
    the minibatch's advantages (fp32)."""
    rng = np.random.default_rng(1)
    advantage = (rng.standard_normal((128, 1)) * 3 + 1).astype(np.float32)
    rollout = {"advantage": torch.from_numpy(advantage.copy())}
    hook = AdvantageNormalization(mini_batch_wise=True)
    assert not hook.pre_update(None, rollout) and torch.equal(rollout["advantage"], torch.from_numpy(advantage))
    batch = {"advantage": torch.from_numpy(advantage)}
    hook.objective(None, {}, batch)
    _, jax_batch, _, _ = JaxAdvantageNormalization(mini_batch_wise=True).objective(
        None, {}, {"advantage": jnp.asarray(advantage)})
    np.testing.assert_allclose(batch["advantage"].numpy(), np.asarray(jax_batch["advantage"]), **FP32)
    assert hook.data_parallel is False and AdvantageNormalization().data_parallel is True


# -- sparse bootstrap -------------------------------------------------------------------


@pytest.fixture(scope="module")
def sparse_agents():
    return build(compute_dtype="float32", sparse_value_bootstrap=True)


@pytest.mark.parametrize("trunc_rate", [0.0, 0.1, 0.9])  # 0.9: more truncated steps than environments
def test_sparse_bootstrap_equals_the_full_pass(sparse_agents, trunc_rate):
    """``value`` and ``next_value`` of the sparse pass equal the full pass's
    (the port's) and JAX's sparse pass; one host read per call."""
    jax_agent, agent = sparse_agents
    rng = np.random.default_rng(7)
    rollout = {"observation": rng.standard_normal((T, N, 16)).astype(np.float32),
               "next_observation": rng.standard_normal((T, N, 16)).astype(np.float32),
               "terminated": rng.random((T, N, 1)) < 0.05, "truncated": rng.random((T, N, 1)) < trunc_rate}
    assert (rollout["truncated"].sum() > N) == (trunc_rate == 0.9)
    hook = agent.get_hook("value_computation")
    assert hook.sparse_bootstrap
    outs = {}
    for sparse in (True, False):
        hook.sparse_bootstrap = sparse
        port = {k: _t(v) for k, v in rollout.items()}
        reads = hook.host_reads
        with torch.no_grad():
            hook.pre_update(agent, port)
        assert hook.host_reads == reads + sparse
        outs[sparse] = port
    hook.sparse_bootstrap = True
    _, jax_out, _ = jax_agent.get_hook("value_computation").pre_update(
        jax_agent.state, jax.tree.map(jnp.asarray, rollout))
    for key in ("value", "next_value"):
        np.testing.assert_allclose(outs[True][key].numpy(), outs[False][key].numpy(), rtol=0, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(outs[True][key].numpy(), np.asarray(jax_out[key]), err_msg=key, **FP32)


# -- the sampler ---------------------------------------------------------------------


def test_epoch_segments_and_validation_match_jax():
    for epochs, counts in ((3, 4), (5, (8, 4, 4, 2, 2)), (5, PO_EPOCHS), (2, (3, 3))):
        assert MiniBatchSampler(epochs, counts).epoch_segments() == JaxMiniBatchSampler(epochs, counts).epoch_segments()
    for args, match in (((3, (4, 2)), "one value per"), ((2, (4, 0)), "positive"), ((0, 2), "positive")):
        for cls in (MiniBatchSampler, JaxMiniBatchSampler):
            with pytest.raises(ValueError, match=match):
                cls(*args)


@pytest.mark.parametrize("block", ["auto", 1, 64, 128, 96])
@pytest.mark.parametrize("counts", [4, PO_EPOCHS, (2, 2, 4, 4, 8)])
def test_epoch_plan_segments_match_jax(counts, block):
    """Segments, blocks, minibatch sizes and counts as JAX's epoch plan at
    32 x 64 rows; a block that does not divide the rollout and the
    minibatch raises the same ``ValueError``; without shuffling every epoch
    keeps the rollout's order."""
    jax_sampler = JaxMiniBatchSampler(5, counts, shuffle_block_size=block)
    sampler = MiniBatchSampler(5, counts, shuffle_block_size=block)
    try:
        jax_plans = jax_sampler.make_epoch_plan(jax.random.key(0), 32, 64, {})
    except ValueError as error:
        with pytest.raises(ValueError, match=str(error).split("(")[0]):
            sampler.make_epoch_plan(32, 64)
        return
    jax_plans = jax_plans if isinstance(jax_plans, list) else [jax_plans]
    plans = sampler.make_epoch_plan(32, 64, torch.Generator().manual_seed(0))
    plans = plans if isinstance(plans, list) else [plans]
    assert len(plans) == len(jax_plans)
    for plan, (meta, perms, batch_size) in zip(plans, jax_plans):
        assert (plan.epoch_start, plan.num_epochs, plan.num_mini_batches, plan.block, plan.batch_size) == (
            meta["epoch_start"], meta["segment_epochs"], meta["total_mini_batches"], meta["shuffle_block"],
            batch_size)
        assert plan.perms.shape == perms.shape
        assert all(sorted(row.tolist()) == list(range(perms.shape[1])) for row in plan.perms)
    unshuffled = [JaxMiniBatchSampler(5, counts, shuffle=False, shuffle_block_size=block),
                  MiniBatchSampler(5, counts, shuffle=False, shuffle_block_size=block)]
    jax_plans = unshuffled[0].make_epoch_plan(jax.random.key(0), 32, 64, {})
    plans = unshuffled[1].make_epoch_plan(32, 64)
    for plan, (_, perms, _) in zip(plans if isinstance(plans, list) else [plans],
                                   jax_plans if isinstance(jax_plans, list) else [jax_plans]):
        np.testing.assert_array_equal(plan.perms.numpy(), np.asarray(perms))


def test_temporal_segments_gather_as_jax():
    """The temporal sampler with per-epoch counts (4, 2, 2) over 512
    environments: the port's plan, fed JAX's environment permutations as
    128-environment tiles, gathers each minibatch JAX's does, with the
    metadata JAX's plan carries."""
    jax_sampler, sampler = JaxTemporalSampler(3, (4, 2, 2)), TemporalMiniBatchSampler(3, (4, 2, 2))
    observation = np.random.default_rng(2).standard_normal((4, 512, 3)).astype(np.float32)
    jax_plans = jax_sampler.make_plan(jax.random.key(4), 4, 512, {})
    tiles = [np.array(indices).reshape(len(indices) // meta["total_mini_batches"], -1)[:, ::128] // 128
             for meta, _, indices in jax_plans]
    plans = sampler.make_epoch_plan(4, 512, epoch_perms=tiles)
    assert [(p.epoch_start, p.num_epochs, p.num_mini_batches, p.block) for p in plans] == [(0, 1, 4, 128),
                                                                                           (1, 2, 2, 128)]
    source = sampler.source({"observation": torch.from_numpy(observation)})
    for plan, (meta, arrays, indices) in zip(plans, jax_plans):
        for k in range(plan.num_epochs * plan.num_mini_batches):
            epoch, mini_batch = divmod(k, plan.num_mini_batches)
            got = sampler.gather(source, plan, epoch, mini_batch)["observation"]
            want = jax_sampler.gather({"observation": jnp.asarray(observation)}, indices[k])["observation"]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            metadata = sampler.metadata(plan, plan.epoch_start + epoch, mini_batch)
            assert (metadata["epoch_index"], metadata["mini_batch_index"], metadata["total_mini_batches"]) == (
                int(arrays["epoch_index"][k]), int(arrays["mini_batch_index"][k]), meta["total_mini_batches"])


# -- path PO's whole update ------------------------------------------------------------


@pytest.fixture(scope="module")
def po_agents():
    """The JAX and the port agents of path PO at SMALL widths:
    ``AdaptiveNormalDistFactory(bijector="softplus")``, minibatch-wise
    advantage normalization, ``sparse_value_bootstrap`` and minibatch counts
    (4, 4, 4, 2, 2)."""
    factories = []
    for get, dist, norm, sampler in ((jax_get_experiment, JaxAdaptiveFactory, JaxAdvantageNormalization,
                                      JaxMiniBatchSampler),
                                     (get_experiment, AdaptiveNormalDistFactory, AdvantageNormalization,
                                      MiniBatchSampler)):
        factory = get("Velocity-Rough", "ppo").make_agent_factory()
        for key, value in {**SMALL, "sparse_value_bootstrap": True}.items():
            setattr(factory, key, value)
        underlying = factory.to_underlying()
        underlying.actor_factory.distribution_factory = dist(bijector="softplus")
        underlying.sampler = sampler(num_epochs=5, num_mini_batches=PO_EPOCHS)
        underlying.hooks = [norm(mini_batch_wise=True) if type(h).__name__ == "AdvantageNormalization" else h
                            for h in underlying.hooks]
        factories.append(underlying)
    return build(factory=tuple(factories), compute_dtype="float32")


def test_po_update_matches_jax(po_agents):
    """One whole update of path PO on both sides, the JAX sampler's five
    epochs of 4, 4, 4, 2 and 2 minibatches fed to the port as two
    segments: every metric, every parameter (the std head's among them) and
    the hook state, fp32 to 1e-5."""
    jax_agent, agent = po_agents
    assert type(agent.actor.distribution).__name__ == "AdaptiveNormalDist"
    assert agent.get_hook("value_computation").sparse_bootstrap
    rollout = rollout_arrays(jax_agent, 31)
    key = jax.random.key(5)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    plans = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
    assert [p[0]["total_mini_batches"] for p in plans] == [4, 2]
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    metrics = agent.update_body(jax.tree.map(_t, rollout), epoch_perms=[np.array(p[1]) for p in plans])
    new = {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic.", "hooks."))}
    paths = compare(jax_metrics, metrics, new, agent, tol=(dict(rtol=1e-5, atol=1e-5),) * 3)
    assert {"actor.distribution.std_head.weight", "actor.distribution.std_head.bias"} <= set(paths)
