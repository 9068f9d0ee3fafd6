"""The port's optimizer families (``cusrl_tpu_torch/template/optimizer.py``)
against the JAX package's ``Optimizer.apply``: adam, adamw, sgd (plain, with
momentum, with Nesterov momentum) and rmsprop, each with two groups at
different learning rates; the ``{prefix: factory}`` mapping (group names,
labels, mixed families); and packed Adam (``CUSRL_TPU_PACKED_ADAM=1``) on
and off.  The same fp32 parameters and gradients (numpy, from a seed) go
through three steps on both sides; parameters agree to rtol 1e-6 (atol 1e-6
for elements near 0): the same elementwise formulas, rounded in the same
order up to Adam's ``sqrt(v) / sqrt(1 - b2^t)`` in ``torch.optim.Adam``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.template import optimizer as jax_optimizer
from cusrl_tpu_torch.template import optimizer as port_optimizer

SHAPES = {
    "actor": {"backbone": {"weight": (8, 6), "bias": (8,)}, "distribution": {"std_param": (3,)}},
    "critic": {"backbone": {"weight": (5, 6)}, "head": {"bias": (1,)}},
    "hooks": {"adversarial_motion_prior": {"discriminator": {"weight": (4, 6), "bias": (4,)}}},
}
TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    return rng.standard_normal(shapes).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {path: leaf for k, v in tree.items() for path, leaf in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _run(jax_factory, port_factory, *, device_lr=False, lr_change=None, steps=3, seed=0):
    """Three steps on both sides; returns (JAX optimizer, port optimizer, JAX
    parameters by path, port parameters by path)."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jax_opt = jax_optimizer.build_optimizer(jax_factory, params)
    jax_params, state, lrs = jax.tree.map(jnp.asarray, params), jax_opt.init(params), jax_opt.init_learning_rates()
    named = [(path, torch.nn.Parameter(torch.from_numpy(leaf.copy()))) for path, leaf in _flat(params).items()]
    opt = port_optimizer.build_optimizer(port_factory, named)
    if device_lr:
        opt.use_device_learning_rates()
    for step, g in enumerate(grads):
        if lr_change is not None and step == steps - 1:
            group, lr = lr_change
            lrs = {**lrs, group: jnp.asarray(lr, jnp.float32)}
            opt.set_learning_rate(group, lr)
        jax_params, state = jax_opt.apply(jax.tree.map(jnp.asarray, g), state, jax_params, lrs)
        flat_g = _flat(g)
        for path, p in named:
            p.grad = torch.from_numpy(flat_g[path].copy())
        opt.step()
    return jax_opt, opt, {k: np.asarray(v) for k, v in _flat(jax_params).items()}, dict(named)


def _assert_params(jax_params, params):
    assert set(jax_params) == set(params)
    for path, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_params[path], err_msg=path, **TOL)


FAMILIES = [
    ("adam", {}),
    ("adam", {"b1": 0.8, "b2": 0.99, "eps": 1e-6}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.3}),
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {}),
    ("rmsprop", {"decay": 0.9, "eps": 1e-4}),
]


@pytest.mark.parametrize("device_lr", [False, True])
@pytest.mark.parametrize("cls,kwargs", FAMILIES)
def test_family_with_two_groups_matches_jax(cls, kwargs, device_lr):
    """Two groups (``critic`` at another lr, changed before the last step)."""
    groups = {"critic": {"lr": 3e-2}}
    jf = jax_optimizer.OptimizerFactory(cls=cls, lr=1e-2, kwargs=dict(kwargs), param_groups=groups)
    tf = port_optimizer.OptimizerFactory(cls=cls, lr=1e-2, kwargs=dict(kwargs), param_groups=groups)
    jax_opt, opt, jax_params, params = _run(jf, tf, device_lr=device_lr, lr_change=("critic", 5e-3))
    assert opt.labels == jax_opt.labels_flat
    assert opt.group_names == jax_opt.group_names == ["critic", "default"]
    _assert_params(jax_params, params)
    expected = torch.optim.Adam if cls == "adam" else port_optimizer.OptaxDirections
    assert type(opt.optimizer) is expected


def test_adamw_and_sgd_factories_match_jax():
    """``AdamWFactory`` (weight decay 1e-2 by default) and ``SgdFactory``
    (lr 1e-2 by default), and the preset module's exports."""
    from cusrl_tpu.preset import optimizer as jax_preset
    from cusrl_tpu_torch.preset import optimizer as preset

    assert preset.__all__ == jax_preset.__all__
    assert port_optimizer.AdamWFactory().kwargs == jax_optimizer.AdamWFactory().kwargs == {"weight_decay": 1e-2}
    assert port_optimizer.SgdFactory().lr == jax_optimizer.SgdFactory().lr == 1e-2
    for jf, tf in ((jax_optimizer.AdamWFactory(lr=1e-2), port_optimizer.AdamWFactory(lr=1e-2)),
                   (jax_optimizer.SgdFactory(kwargs={"momentum": 0.5}), port_optimizer.SgdFactory(
                       kwargs={"momentum": 0.5}))):
        _assert_params(*_run(jf, tf)[2:])


def test_prefix_factory_mapping_matches_jax():
    """``{prefix: factory}``: each prefix owns a group named after it, a
    factory's ``param_groups`` become ``"{prefix}.{sub_prefix}"`` groups, the
    first factory's group is the default, the longest prefix wins, unused
    groups are dropped; the families mix (Adam, SGD with Nesterov momentum,
    AdamW)."""

    def mapping(module):
        return {
            "actor": module.AdamFactory(lr=1e-3, param_groups={"actor.distribution": {"lr": 1e-2},
                                                               "actor.unused": {"lr": 5.0}}),
            "critic": module.SgdFactory(lr=2e-2, kwargs={"momentum": 0.9, "nesterov": True}),
            "hooks.adversarial_motion_prior": module.AdamWFactory(lr=3e-3, kwargs={"weight_decay": 0.05}),
            "unused": module.SgdFactory(),
        }

    jax_opt, opt, jax_params, params = _run(mapping(jax_optimizer), mapping(port_optimizer),
                                            lr_change=("actor.actor.distribution", 2e-3))
    assert opt.labels == jax_opt.labels_flat
    assert opt.group_names == jax_opt.group_names == [
        "actor", "actor.actor.distribution", "critic", "hooks.adversarial_motion_prior"]
    assert opt.labels["hooks.adversarial_motion_prior.discriminator.weight"] == "hooks.adversarial_motion_prior"
    assert opt.base_learning_rates == jax_opt.base_learning_rates
    _assert_params(jax_params, params)


def test_mapping_default_group_is_the_first_factorys():
    """Paths no prefix matches fall into the first factory's group."""
    names = [("actor.w", torch.nn.Parameter(torch.zeros(2))), ("other.w", torch.nn.Parameter(torch.zeros(2)))]
    opt = port_optimizer.build_optimizer({"critic": port_optimizer.AdamFactory(),
                                          "actor": port_optimizer.SgdFactory()}, names)
    params = {"actor": {"w": np.zeros(2, np.float32)}, "other": {"w": np.zeros(2, np.float32)}}
    jax_opt = jax_optimizer.build_optimizer({"critic": jax_optimizer.AdamFactory(),
                                             "actor": jax_optimizer.SgdFactory()}, params)
    assert opt.labels == jax_opt.labels_flat == {"actor.w": "actor", "other.w": "critic"}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("device_lr", [False, True])
def test_packed_adam_matches_jax(packed, device_lr, monkeypatch):
    """Packed Adam (``CUSRL_TPU_PACKED_ADAM=1``, off by default): one flat
    fp32 vector with a per-element lr where the groups' rates differ, on
    both sides, against JAX's packed and default update."""
    monkeypatch.setenv("CUSRL_TPU_PACKED_ADAM", "1" if packed else "0")
    groups = {"critic": {"lr": 3e-2}, "hooks": {"lr": 2e-3}}
    jf = jax_optimizer.AdamFactory(lr=1e-2, param_groups=groups)
    tf = port_optimizer.AdamFactory(lr=1e-2, param_groups=groups)
    jax_opt, opt, jax_params, params = _run(jf, tf, device_lr=device_lr, lr_change=("critic", 5e-3))
    assert (jax_opt.packed_adam is not None) == packed == opt.packed
    assert type(opt.optimizer) is (port_optimizer.PackedAdam if packed else torch.optim.Adam)
    _assert_params(jax_params, params)


def test_packed_adam_applies_only_where_jax_packs(monkeypatch):
    """Not packed: a family but Adam, moments that differ between factories,
    a group overriding more than its lr; packed by default nowhere."""
    named = [("actor.w", torch.nn.Parameter(torch.zeros(3)))]
    assert not port_optimizer.build_optimizer(port_optimizer.AdamFactory(), named).packed
    monkeypatch.setenv("CUSRL_TPU_PACKED_ADAM", "1")
    assert port_optimizer.build_optimizer(port_optimizer.AdamFactory(), named).packed
    for factory in (port_optimizer.AdamWFactory(),
                    port_optimizer.AdamFactory(param_groups={"actor": {"b1": 0.5}}),
                    {"actor": port_optimizer.AdamFactory(), "critic": port_optimizer.AdamFactory(kwargs={"b2": 0.9})}):
        assert not port_optimizer.build_optimizer(factory, named).packed


def test_packed_adam_state_views_restore_with_the_snapshot(monkeypatch):
    """Packed Adam's per-parameter ``exp_avg``/``exp_avg_sq`` are views of
    its flat moments: writing through them (as ``restore_snapshot`` does)
    changes the next step exactly as the per-parameter optimizer's state."""
    monkeypatch.setenv("CUSRL_TPU_PACKED_ADAM", "1")
    rng = np.random.default_rng(4)
    named = [(f"actor.{i}", torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32))))
             for i, s in enumerate(((3, 2), (4,)))]
    opt = port_optimizer.build_optimizer(port_optimizer.AdamFactory(lr=1e-2), named)
    for _, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.optimizer.state
    for _, p in named:
        state[p]["exp_avg"].copy_(torch.zeros_like(p))
        state[p]["exp_avg_sq"].copy_(torch.zeros_like(p))
    state[named[0][1]]["step"].zero_()
    before = [p.detach().clone() for _, p in named]
    opt.step()  # a first step again: p -= lr * g / (|g| + eps)
    for (_, p), b in zip(named, before):
        np.testing.assert_allclose(p.detach().numpy(), (b - 1e-2).numpy(), rtol=1e-6, atol=1e-7)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        port_optimizer.build_optimizer(port_optimizer.OptimizerFactory(cls="lamb"),
                                       [("actor.w", torch.nn.Parameter(torch.zeros(1)))])
