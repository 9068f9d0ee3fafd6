"""The port's remaining layers and backbones against the JAX package, on the
CPU: the GLU activations and the small utility layers, the frozen affine
normalizations, SimBa, the separable and plain convolutions and the Cnn, the
positional encodings, and the public attention layers (``MultiheadAttention``
called as a layer, its cross-attention form and QK-norm, the encoder and
decoder layers).  Then SimBa and Cnn backbones in a whole PPO agent: one
update on both sides from the same weights (``load_jax_state``, which
carries the convolutions' HWIO weights into PyTorch's layout), the same
rollout and the same minibatch plan.

Weights come from the JAX modules (``load_jax_params``); inputs are made with
numpy from a seed.  Tolerances: fp32 paths 1e-5 (the same arithmetic summed
in another order); bf16 paths 2e-2 (one bf16 rounding of values of order 1
that can fall the other way when the two sides sum in another order).
Gradients are held per leaf to the leaf's largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.layer import activation as jact
from cusrl_tpu.nn.layer import encoding as jenc
from cusrl_tpu.nn.layer import mha as jmha
from cusrl_tpu.nn.layer import separable_conv as jsep
from cusrl_tpu.nn.module import cnn as jcnn
from cusrl_tpu.nn.module import normalization as jnorm
from cusrl_tpu.nn.module import simba as jsimba
from cusrl_tpu_torch.nn.layer import activation as tact
from cusrl_tpu_torch.nn.layer import encoding as tenc
from cusrl_tpu_torch.nn.layer import mha as tmha
from cusrl_tpu_torch.nn.layer import separable_conv as tsep
from cusrl_tpu_torch.nn.module import cnn as tcnn
from cusrl_tpu_torch.nn.module import normalization as tnorm
from cusrl_tpu_torch.nn.module import simba as tsimba
from cusrl_tpu_torch.utils.interop import load_jax_params

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD_REL = {None: 1e-5, "bfloat16": 2e-2}  # max |port - jax| / max |jax|, per gradient leaf
DTYPES = [None, "bfloat16"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _carry(jax_module, module):
    return load_jax_params(module, {p: np.asarray(v) for p, v in tree_paths(jax_module)})


def _grads_close(jax_grads, module, dtype):
    """Each leaf within ``GRAD_REL`` of its largest element.  A leaf whose
    exact gradient is 0 (a key bias: softmax does not see a shift common to
    all keys) holds rounding noise; its scale is floored at a hundredth of
    the largest leaf's.  A parameter the output does not reach has no ``.grad``
    in the port and zeros in JAX."""
    given = {p: _np(v) for p, v in tree_paths(jax_grads)}
    named = dict(module.named_parameters())
    assert set(given) == {p for p, v in named.items() if v.requires_grad}
    floor = 1e-2 * max(np.abs(v).max() for v in given.values())
    for path, want in given.items():
        got = named[path].grad
        got = torch.zeros(named[path].shape) if got is None else got
        layout = getattr(module.get_submodule(path.rpartition(".")[0]), "jax_layouts", {}).get(path.rpartition(".")[2])
        got = _np(got if layout is None else got.permute(layout))
        assert np.abs(got - want).max() <= GRAD_REL[dtype] * max(np.abs(want).max(), floor), path


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Activations and utility layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["geglu", "swiglu"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_glu_activations_match_jax(name, dtype):
    x = _rand((5, 3, 16), 0, 2.0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = getattr(jact, name)(jnp.asarray(x, jdt))
    layer = {"geglu": tact.GeGlu, "swiglu": tact.SwiGlu}[name]()
    got = layer(torch.tensor(x, dtype=tdt))
    assert got.shape == (5, 3, 8) and got.dtype == tdt
    _close(got, want, FP32 if dtype == np.float32 else BF16)
    _close(getattr(tact, name)(torch.tensor(x)), getattr(jact, name)(jnp.asarray(x)), FP32)


def test_detach_gradient_and_parameter_wrapper_match_jax():
    value = _rand((3, 4), 1)
    j = jact.ParameterWrapper(value=jnp.asarray(value))
    t = _carry(j, tact.ParameterWrapper(torch.zeros(3, 4)))
    _close(t(torch.zeros(2)), j(jnp.zeros(2)), dict(rtol=0, atol=0))
    (t() * torch.arange(12.0).reshape(3, 4)).sum().backward()
    _grads_close(jax.grad(lambda m: jnp.sum(m() * jnp.arange(12.0).reshape(3, 4)))(j), t, None)
    x = torch.tensor(_rand((4,), 2), requires_grad=True)
    (tact.DetachGradient()(x) * x).sum().backward()
    jgrad = jax.grad(lambda a: jnp.sum(jact.DetachGradient()(a) * a))(jnp.asarray(x.detach().numpy()))
    _close(x.grad, jgrad, FP32)


@pytest.mark.parametrize("kind", ["Normalization", "Denormalization"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_normalizations_match_jax(kind, dtype):
    scale, shift = np.abs(_rand((6,), 3)) + 0.5, _rand((6,), 4)
    j = getattr(jnorm, kind).init(scale, shift)
    t = getattr(tnorm, kind)(np.zeros(6), np.zeros(6))
    _carry(j, t)
    assert not any(p.requires_grad for p in t.parameters()) and t.input_dim == t.output_dim == 6
    x = _rand((2, 3, 6), 5, 3.0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want, jmem, _ = j(jnp.asarray(x, jdt))
    got, mem, aux = t(torch.tensor(x, dtype=tdt))
    assert got.dtype == tdt and mem is None and aux == {}
    _close(got, want, FP32 if dtype == np.float32 else BF16)


# ---------------------------------------------------------------------------
# SimBa, convolutions, Cnn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_simba_matches_jax(dtype, monkeypatch):
    from cusrl_tpu_torch.utils.config import CONFIG

    monkeypatch.setattr(CONFIG, "compute_dtype", "unused")  # the factories take the dtype given
    kwargs = dict(hidden_dim=32, num_blocks=2, activation="relu", compute_dtype=dtype)
    j = jsimba.SimbaFactory(**kwargs)(10, None, jax.random.key(0))
    t = _carry(j, tsimba.SimbaFactory(**kwargs)(10, None))
    assert t.output_dim == 32 and t.blocks[0].up.output_dim == 128 and t.final_norm.epsilon == 1e-6
    x = _rand((7, 10), 6)
    tgt = _rand((7, 32), 7)

    def jloss(m):
        out = m(jnp.asarray(x))[0]
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out, memory, _ = t(torch.from_numpy(x))
    assert memory is None
    _close(out, jout, FP32 if dtype is None else BF16)
    (out.float() - torch.from_numpy(tgt)).square().mean().backward()
    _grads_close(jgrads, t, dtype)


@pytest.mark.parametrize("padding,stride,multiplier,size",
                         [("SAME", 1, 1, (7, 7)), ("SAME", 2, 2, (8, 7)), ("VALID", 2, 1, (9, 6)),
                          (((1, 0), (2, 1)), 1, 1, (5, 6))])
def test_separable_conv_matches_jax(padding, stride, multiplier, size):
    j = jsep.SeparableConv2d.init(jax.random.key(1), 3, 5, 3, stride, padding, multiplier)
    t = _carry(j, tsep.SeparableConv2d(3, 5, 3, stride, padding, multiplier))
    assert t.depthwise.shape == (3 * multiplier, 1, 3, 3) and t.pointwise.shape == (5, 3 * multiplier, 1, 1)
    x = _rand((2, *size, 3), 8)

    def jloss(m, a):
        out = m(a)
        return jnp.sum(jnp.square(out)), out

    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(j, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = t(tx)
    assert out.shape == jout.shape
    _close(out, jout, FP32)
    out.square().sum().backward()
    _grads_close(jgrads, t, None)
    _close(tx.grad, jdx, dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("padding,stride", [("VALID", 2), ("SAME", 2), ("SAME", 3)])
def test_conv2d_matches_jax(dtype, padding, stride):
    j = jcnn.Conv2d.init(jax.random.key(2), 3, 4, (3, 2), stride, padding, compute_dtype=dtype)
    t = _carry(j, tcnn.Conv2d(3, 4, (3, 2), stride, padding, compute_dtype=dtype))
    x = _rand((2, 8, 7, 3), 9)
    want, got = j(jnp.asarray(x)), t(torch.from_numpy(x))
    assert got.shape == want.shape and str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, FP32 if dtype is None else BF16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cnn_matches_jax(dtype):
    kwargs = dict(input_shape=(12, 10, 3), channels=(4, 6), kernel_sizes=(4, 3), strides=(2, 1), hidden_dim=16,
                  compute_dtype=dtype)
    j = jcnn.CnnFactory(**kwargs)(360, None, jax.random.key(3))
    t = _carry(j, tcnn.CnnFactory(**kwargs)(360, None))
    assert t.input_dim == 360 and t.output_dim == 16 and t.head.input_dim == 3 * 2 * 6
    x = _rand((2, 3, 360), 10)
    tgt = _rand((2, 3, 16), 11)

    def jloss(m):
        out = m(jnp.asarray(x))[0]
        return jnp.mean(jnp.square(out - tgt)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out, _, _ = t(torch.from_numpy(x))
    assert out.shape == (2, 3, 16) and out.dtype == torch.float32
    _close(out, jout, FP32 if dtype is None else BF16)
    (out - torch.from_numpy(tgt)).square().mean().backward()
    _grads_close(jgrads, t, dtype)
    # An image-shaped input [..., H, W, C] gives the same rows.
    image, _, _ = t(torch.from_numpy(x.reshape(2, 3, 12, 10, 3)))
    torch.testing.assert_close(image, out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="input_shape"):
        tcnn.CnnFactory(**kwargs)(359, None)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def test_positional_encodings_match_jax():
    positions = np.arange(12).reshape(3, 4) * 7
    _close(tenc.SinusoidalPositionalEncoding(10, 500.0)(torch.from_numpy(positions)),
           jenc.SinusoidalPositionalEncoding(dim=10, max_wavelength=500.0)(jnp.asarray(positions)), FP32)
    rows, cols = np.arange(5), np.arange(5)[::-1].copy()
    _close(tenc.Sinusoidal2dPositionalEncoding(16)(torch.from_numpy(rows), torch.from_numpy(cols)),
           jenc.Sinusoidal2dPositionalEncoding(dim=16)(jnp.asarray(rows), jnp.asarray(cols)), FP32)
    j = jenc.LearnablePositionalEncoding.init(jax.random.key(4), 90, 6)
    t = _carry(j, tenc.LearnablePositionalEncoding(90, 6))
    _close(t(torch.from_numpy(positions)), j(jnp.asarray(positions)), dict(rtol=0, atol=0))
    # The table's gradient: repeated positions accumulate.
    repeated = np.array([[3, 3, 5], [0, 5, 89]])
    jgrads = jax.grad(lambda m: jnp.sum(jnp.square(m(jnp.asarray(repeated)))))(j)
    t(torch.from_numpy(repeated)).square().sum().backward()
    _grads_close(jgrads, t, None)
    assert abs(float(tenc.LearnablePositionalEncoding(400, 8).table.detach().std()) - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# Public attention layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qk_norm,rope", [(False, True), (True, True), (True, False)])
def test_multihead_attention_layer_matches_jax(dtype, qk_norm, rope):
    """The layer called as a whole: self-attention with a key mask (a head
    axis added) and an ALiBi-like bias, then cross-attention over a
    ``kv_dim``-wide memory padded to a longer key axis; outputs and every
    gradient (the QK-norm scales among them)."""
    j = jmha.MultiheadCrossAttention.init(jax.random.key(5), 16, 2, kv_dim=12, qk_norm=qk_norm, rope=rope,
                                          compute_dtype=dtype)
    t = _carry(j, tmha.MultiheadCrossAttention(16, 2, kv_dim=12, qk_norm=qk_norm, rope=rope, compute_dtype=dtype))
    assert (t.q_norm is not None) == qk_norm and t.k_proj.input_dim == 12
    q, kv = _rand((3, 5, 16), 12), _rand((3, 6, 12), 13)
    rng = np.random.default_rng(14)
    mask = rng.random((3, 5, 8)) < 0.7
    mask[0, 1] = False  # a query that sees no key
    mask[..., 6:] &= False
    bias = _rand((2, 5, 8), 15)

    def jloss(m):
        out = m(jnp.asarray(q), jnp.asarray(kv), mask=jnp.asarray(mask), bias=jnp.asarray(bias), kv_pad_to=8)
        return jnp.mean(jnp.square(out.astype(jnp.float32))), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out = t(torch.from_numpy(q), torch.from_numpy(kv), mask=torch.from_numpy(mask), bias=torch.from_numpy(bias),
            kv_pad_to=8)
    _close(out, jout, FP32 if dtype is None else BF16)
    out.float().square().mean().backward()
    _grads_close(jgrads, t, dtype)
    with pytest.raises(ValueError, match="key/value"):
        t(torch.from_numpy(q), None)
    # The self-attention alias, with the query as keys and no mask.
    assert tmha.MultiheadSelfAttention is tmha.MultiheadAttention
    js = jmha.MultiheadSelfAttention.init(jax.random.key(6), 16, 4, qk_norm=qk_norm, rope=rope, compute_dtype=dtype)
    ts = _carry(js, tmha.MultiheadSelfAttention(16, 4, qk_norm=qk_norm, rope=rope, compute_dtype=dtype))
    _close(ts(torch.from_numpy(q)), js(jnp.asarray(q)), FP32 if dtype is None else BF16)


@pytest.mark.parametrize("norm_mode", ["pre", "post", "none"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_encoder_layer_matches_jax(norm_mode, dtype):
    j = jmha.TransformerEncoderLayer.init(jax.random.key(7), 16, 2, ff_dim=32, norm_mode=norm_mode, qk_norm=True,
                                          rope=True, compute_dtype=dtype)
    t = _carry(j, tmha.TransformerEncoderLayer(16, 2, ff_dim=32, norm_mode=norm_mode, qk_norm=True, rope=True,
                                               compute_dtype=dtype))
    assert t.feed_forward.up.compute_dtype is None  # JAX builds the FFN without the attention's dtype
    x, tgt = _rand((3, 6, 16), 16), _rand((3, 6, 16), 20)
    mask = np.tril(np.ones((6, 6), bool))[None].repeat(3, 0)

    def jloss(m):
        out = m(jnp.asarray(x), mask=jnp.asarray(mask))
        return jnp.mean(jnp.square(out - tgt)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out = t(torch.from_numpy(x), mask=torch.from_numpy(mask))
    _close(out, jout, FP32 if dtype is None else BF16)
    (out.float() - torch.from_numpy(tgt)).square().mean().backward()
    _grads_close(jgrads, t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_decoder_layer_matches_jax(dtype):
    j = jmha.TransformerDecoderLayer.init(jax.random.key(8), 16, 2, memory_dim=10, ff_dim=24, compute_dtype=dtype)
    t = _carry(j, tmha.TransformerDecoderLayer(16, 2, memory_dim=10, ff_dim=24, compute_dtype=dtype))
    x, memory, tgt = _rand((2, 5, 16), 17), _rand((2, 7, 10), 18), _rand((2, 5, 16), 21)
    self_mask = np.tril(np.ones((5, 5), bool))[None].repeat(2, 0)
    cross_mask = np.random.default_rng(19).random((2, 5, 7)) < 0.8

    def jloss(m):
        out = m(jnp.asarray(x), jnp.asarray(memory), self_mask=jnp.asarray(self_mask),
                cross_mask=jnp.asarray(cross_mask))
        return jnp.mean(jnp.square(out - tgt)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out = t(torch.from_numpy(x), torch.from_numpy(memory), self_mask=torch.from_numpy(self_mask),
            cross_mask=torch.from_numpy(cross_mask))
    _close(out, jout, FP32 if dtype is None else BF16)
    (out.float() - torch.from_numpy(tgt)).square().mean().backward()
    _grads_close(jgrads, t, dtype)


def test_encoder_layer_feed_forward_routes_to_the_kernel_as_jax(monkeypatch):
    """With bf16 FFN layers (the JAX rule's condition) a CUDA input of at
    least 256 rows takes the fused chain; fp32 ones never do."""
    layer = tmha.TransformerEncoderLayer(16, 2, ff_dim=32)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    x = torch.zeros(8, 32, 16)
    assert not layer.feed_forward._can_fuse(x)
    for linear in (layer.feed_forward.up, layer.feed_forward.down):
        linear.compute_dtype = "bfloat16"
    assert layer.feed_forward._can_fuse(x) and not layer.feed_forward._can_fuse(x[:, :31])


# ---------------------------------------------------------------------------
# SimBa and Cnn backbones in a whole PPO agent
# ---------------------------------------------------------------------------

T, N, ACT = 8, 64, 4
AGENT_KWARGS = dict(num_steps_per_update=T, lr=1e-3, sampler_epochs=2, sampler_mini_batches=2,
                    entropy_loss_weight=0.005)


def _agent_update(backbone, obs_dim, compute_dtype, monkeypatch):
    from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
    from cusrl_tpu.preset.ppo import PpoAgentFactory as JaxPpoFactory
    from cusrl_tpu.utils import misc as jax_misc
    from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
    from cusrl_tpu_torch.utils.config import CONFIG
    from cusrl_tpu_torch.utils.interop import load_jax_state

    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    jf, tf = JaxPpoFactory(**AGENT_KWARGS), PpoAgentFactory(**AGENT_KWARGS)
    jf._backbone_factory = lambda dims: backbone[0]
    tf._backbone_factory = lambda dims: backbone[1]
    jax_agent = jf(JaxEnv(num_instances=N, observation_dim=obs_dim, action_dim=ACT).spec)
    agent = tf(VelocityLocomotionEnv(num_instances=N, observation_dim=obs_dim, action_dim=ACT, device="cpu").spec,
               device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])

    rng = np.random.default_rng(20)
    obs = np.tanh(rng.standard_normal((T, N, obs_dim))).astype(np.float32)
    next_obs = np.tanh(rng.standard_normal((T, N, obs_dim))).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs))
    action = dist["mean"] + dist["std"] * rng.standard_normal((T, N, ACT)).astype(np.float32)
    terminated, truncated = rng.random((T, N, 1)) < 0.05, rng.random((T, N, 1)) < 0.05
    rollout = {
        "observation": obs, "next_observation": next_obs, "action": np.asarray(action),
        "action_logp": np.asarray(jax_agent.state.actor.compute_logp(dist, action)),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((T, N, 1)).astype(np.float32),
        "terminated": terminated, "truncated": truncated, "done": terminated | truncated,
    }
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    key = jax.random.key(5)
    _, perms, _ = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    metrics = agent.update_body(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rollout),
                                epoch_perms=np.array(perms))
    new_params = {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic."))}
    return jax_metrics, metrics, new_params, agent


@pytest.mark.parametrize("kind", ["simba", "cnn"])
def test_backbone_in_a_whole_ppo_update_matches_jax(kind, monkeypatch):
    """One fp32 update (2 epochs x 2 minibatches at lr 1e-3) with the backbone
    as actor and critic: metrics to fp32 summation order carried through 4
    Adam steps, every parameter after the update (a Cnn's convolution weights
    read back in JAX's layout) within a few 1e-6."""
    from cusrl_tpu_torch.utils.interop import state_entries

    if kind == "simba":
        backbone = (jsimba.SimbaFactory(hidden_dim=32), tsimba.SimbaFactory(hidden_dim=32))
        obs_dim = 16
    else:
        kwargs = dict(input_shape=(6, 6, 2), channels=(4, 8), kernel_sizes=(3, 2), strides=(1, 2), hidden_dim=16)
        backbone = (jcnn.CnnFactory(**kwargs), tcnn.CnnFactory(**kwargs))
        obs_dim = 72
    jax_metrics, metrics, new_params, agent = _agent_update(backbone, obs_dim, None, monkeypatch)
    assert set(metrics) == set(jax_metrics)
    for name, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=name, rtol=1e-5, atol=5e-6)
    entries = {p: e for p, e in state_entries(agent).items() if e.kind == "parameter"}
    assert set(entries) == set(new_params)
    for path, expected in new_params.items():
        np.testing.assert_allclose(entries[path].read(), expected, err_msg=path, rtol=0, atol=5e-6)
