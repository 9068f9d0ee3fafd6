"""The port's transformer modules against the JAX package, on the CPU.

RoPE and ALiBi, LayerNorm, the gates, the multi-head attention projections,
FeedForward, ``CausalMultiheadSelfAttention`` in its step, lane, batched and
scan modes, the encoder layer in its three norm modes, ``Sequential`` with
``sequential_with_ctx`` and ``eval_next_token``, and the orthogonal
initialization's reach.  Weights come from the JAX modules and are carried
into the port by parameter path; inputs are made with numpy from a seed.

Tolerances: fp32 paths 1e-5 (the same arithmetic summed in another order);
bf16 paths 2e-2, one bf16 rounding of values of order 1 (2^-8 relative) that
can flip when the two sides sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.control.initialization import map_linear_layers
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.layer import encoding as jenc
from cusrl_tpu.nn.layer import gate as jgate
from cusrl_tpu.nn.layer import mha as jmha
from cusrl_tpu.nn.module import causal_attn as jca
from cusrl_tpu.nn.module.mlp import MlpFactory as JaxMlpFactory
from cusrl_tpu.nn.module.sequential import SequentialFactory as JaxSequentialFactory
from cusrl_tpu_torch.nn.base import reset_memory, storable_memory
from cusrl_tpu_torch.nn.layer import encoding as tenc
from cusrl_tpu_torch.nn.layer import gate as tgate
from cusrl_tpu_torch.nn.layer import mha as tmha
from cusrl_tpu_torch.nn.module import causal_attn as tca
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.nn.module.sequential import SequentialFactory

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = [None, "bfloat16"]


def _tol(dtype):
    return FP32 if dtype is None else BF16


def _carry(jax_module, module):
    """Copies the JAX module's parameters into the port's, by path."""
    given = {path: np.asarray(leaf) for path, leaf in tree_paths(jax_module)}
    params = dict(module.named_parameters())
    assert set(params) == set(given)
    with torch.no_grad():
        for path, param in params.items():
            param.copy_(torch.from_numpy(np.array(given[path])))
    return module


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _sequence(t_len, batch, dim, seed, p_done=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t_len, batch, dim)).astype(np.float32)
    done = rng.random((t_len, batch, 1)) < p_done
    return x, done


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 7, 8)).astype(np.float32)
    positions = np.arange(7) + 5
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.tensor(x, dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = jenc.RotaryEmbedding(dim=8)(jx, jnp.asarray(positions))
    got = tenc.RotaryEmbedding(8)(tx, torch.from_numpy(positions))
    assert got.dtype == tx.dtype
    _close(got, want, FP32 if dtype == np.float32 else dict(rtol=0, atol=0))


@pytest.mark.parametrize("heads", [1, 2, 4, 6, 8])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_allclose(np.asarray(tenc.alibi_slopes(heads), np.float32),
                               np.asarray(jenc.alibi_slopes(heads)), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 16)) * 3 + 1).astype(np.float32)
    j = jmha._LayerNorm(scale=jnp.asarray(rng.random(16) + 0.5, jnp.float32),
                        bias=jnp.asarray(rng.standard_normal(16), jnp.float32))
    t = _carry(j, tmha.LayerNorm(16))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    got = t(torch.tensor(x, dtype=tdt))
    assert got.dtype == tdt
    # The population variance (jnp.var), not torch.var's unbiased default.
    _close(got, j(jnp.asarray(x, jdt)), FP32 if dtype == np.float32 else BF16)


@pytest.mark.parametrize("kind", ["passthrough", "residual", "input", "output", "highway", "sigmoid_tanh", "gru"])
def test_gates_match_jax(kind):
    j = jgate.make_gate(kind, 8, jax.random.key(2))
    t = _carry(j, tgate.make_gate(kind, 8))
    rng = np.random.default_rng(2)
    x, y = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    _close(t(torch.from_numpy(x), torch.from_numpy(y)), j(jnp.asarray(x), jnp.asarray(y)), FP32)


def test_scaled_dot_product_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    k, v = (rng.standard_normal((3, 2, 6, 8)).astype(np.float32) for _ in range(2))
    mask = rng.random((3, 1, 5, 6)) < 0.5
    mask[0, :, 2] = False  # a query with no valid key: exactly 0
    bias = rng.standard_normal((2, 5, 6)).astype(np.float32)
    want = jmha.scaled_dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
                                             bias=jnp.asarray(bias))
    got = tmha.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(mask),
                                            bias=torch.from_numpy(bias))
    _close(got, want, FP32)
    assert not got[0, :, 2].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_projections_match_jax(dtype):
    j = jmha.MultiheadAttention.init(jax.random.key(4), 16, 2, rope=True, compute_dtype=dtype)
    t = _carry(j, tmha.MultiheadAttention(16, 2, rope=True, compute_dtype=dtype))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, 16)).astype(np.float32)
    positions = np.arange(6) + 4
    jq, jk, jv = j.project_qkv_raw(jnp.asarray(x), q_positions=jnp.asarray(positions))
    tq, tk, tv = t.project_qkv_raw(torch.from_numpy(x), q_positions=torch.from_numpy(positions))
    for got, want in ((tq, jq), (tk, jk), (tv, jv), (t.rope_k(tk, torch.from_numpy(positions)),
                                                     j.rope_k(jk, jnp.asarray(positions)))):
        assert got.shape == want.shape and str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got, want, _tol(dtype))
    heads = rng.standard_normal((3, 2, 6, 8)).astype(np.float32)
    _close(t.merge_output(torch.from_numpy(heads)), j.merge_output(jnp.asarray(heads)), _tol(dtype))
    # QK-norm: the RMS norm of each head's q and k (non-unit scales), before RoPE on q; k stays un-rotated.
    jn = jmha.MultiheadAttention.init(jax.random.key(4), 16, 2, qk_norm=True, rope=True, compute_dtype=dtype)
    jn = jn.replace(q_norm=jn.q_norm.replace(scale=jnp.asarray(rng.random(8) + 0.5, jnp.float32)),
                    k_norm=jn.k_norm.replace(scale=jnp.asarray(rng.random(8) + 0.5, jnp.float32)))
    tn = _carry(jn, tmha.MultiheadAttention(16, 2, qk_norm=True, rope=True, compute_dtype=dtype))
    want = jn.project_qkv_raw(jnp.asarray(x), q_positions=jnp.asarray(positions))
    got = tn.project_qkv_raw(torch.from_numpy(x), q_positions=torch.from_numpy(positions))
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        _close(g, w, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_feed_forward_matches_jax(dtype, monkeypatch):
    j = jmha.FeedForward.init(jax.random.key(5), 16, 64, compute_dtype=dtype)
    t = _carry(j, tmha.FeedForward(16, 64, compute_dtype=dtype))
    x = np.random.default_rng(5).standard_normal((300, 16)).astype(np.float32)
    want = j(jnp.asarray(x))
    _close(t(torch.from_numpy(x)), want, _tol(dtype))
    assert not t._can_fuse(torch.from_numpy(x))  # CPU tensors keep the modular chain
    if dtype is not None:
        # The kernel route (K1 with gelu) on the CPU: the rule without "on CUDA".
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        assert t._can_fuse(torch.zeros(300, 16)) and not t._can_fuse(torch.zeros(255, 16))
        monkeypatch.undo()
        monkeypatch.setattr(tmha.FeedForward, "_can_fuse", lambda self, x: True)
        _close(t(torch.from_numpy(x)), want, BF16)


def _attention_pair(window, use_alibi, use_rope, dtype, mode):
    j = jca.CausalMultiheadSelfAttention(
        mha=jmha.MultiheadAttention.init(jax.random.key(6), 16, 2, rope=use_rope, compute_dtype=dtype),
        window=window, use_alibi=use_alibi, input_dim=16, sequence_mode="scan" if mode == "scan" else "batched")
    t = tca.CausalMultiheadSelfAttention(tmha.MultiheadAttention(16, 2, rope=use_rope, compute_dtype=dtype),
                                         window=window, use_alibi=use_alibi, input_dim=16, sequence_mode=mode)
    return j, _carry(j, t)


def _warm(j, t, batch, seed):
    """A few steps with a reset, so the ring is part-full and the cursor is
    not 0; returns both memories."""
    x, done = _sequence(3, batch, 16, seed)
    jm, tm = j.init_memory(batch), t.init_memory(batch)
    for step in range(3):
        _, jm, _ = j(jnp.asarray(x[step]), jm)
        _, tm, _ = t(torch.from_numpy(x[step]), tm)
        jm, tm = _jax_reset(jm, done[step]), reset_memory(tm, torch.from_numpy(done[step]))
    return jm, tm


def _jax_reset(memory, done):
    from cusrl_tpu.nn.base import reset_memory as jax_reset_memory

    return jax_reset_memory(memory, jnp.asarray(done))


def _memory_close(got, want, tol):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], tol if key in ("k_cache", "v_cache") else dict(rtol=0, atol=0))


@pytest.mark.parametrize("mode", ["lane", "batched", "scan"])
@pytest.mark.parametrize("use_alibi,use_rope", [(False, True), (True, False)])
def test_attention_sequence_modes_match_jax(mode, use_alibi, use_rope):
    window, batch = 4, 3
    j, t = _attention_pair(window, use_alibi, use_rope, None, mode)
    jm, tm = _warm(j, t, batch, seed=7)
    x, done = _sequence(9, batch, 16, seed=8)
    jo, jm2, _ = j(jnp.asarray(x), jm, sequential=True, done=jnp.asarray(done))
    to, tm2, _ = t(torch.from_numpy(x), tm, sequential=True, done=torch.from_numpy(done))
    _close(to, jo, FP32)
    _memory_close(tm2, jm2, FP32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_step_matches_jax_across_the_ring(dtype):
    """Steps past a full turn of the ring (the cursor wraps) with resets."""
    window, batch = 3, 4
    j, t = _attention_pair(window, True, True, dtype, "auto")
    jm, tm = j.init_memory(batch), t.init_memory(batch)
    assert tm["k_cache"].dtype == (torch.float32 if dtype is None else torch.bfloat16)
    x, done = _sequence(2 * window + 3, batch, 16, seed=9)
    for step in range(x.shape[0]):
        jo, jm, _ = j(jnp.asarray(x[step]), jm)
        to, tm, _ = t(torch.from_numpy(x[step]), tm)
        _close(to, jo, _tol(dtype))
        _memory_close(tm, jm, _tol(dtype))
        jm, tm = _jax_reset(jm, done[step]), reset_memory(tm, torch.from_numpy(done[step]))
    assert int(tm["cursor"]) == x.shape[0] % (window + 1)


def test_lane_mode_matches_scan_mode_with_dones():
    """The port's lane route (K3's plain version here) against its own scan
    cell, the definitional reference: outputs, and the next steps taken from
    each final memory (the scan's ring is in another slot order)."""
    window, batch = 4, 5
    _, lane = _attention_pair(window, False, True, None, "lane")
    scan = tca.CausalMultiheadSelfAttention(lane.mha, window=window, input_dim=16, sequence_mode="scan")
    memory = lane.init_memory(batch)
    x0, d0 = _sequence(3, batch, 16, seed=10)
    for step in range(3):
        _, memory, _ = lane(torch.from_numpy(x0[step]), memory)
        memory = reset_memory(memory, torch.from_numpy(d0[step]))
    x, done = _sequence(10, batch, 16, seed=11, p_done=0.3)
    lo, lm, _ = lane(torch.from_numpy(x), memory, sequential=True, done=torch.from_numpy(done))
    so, sm, _ = scan(torch.from_numpy(x), memory, sequential=True, done=torch.from_numpy(done))
    _close(lo, so, FP32)
    y = np.random.default_rng(12).standard_normal((3, batch, 16)).astype(np.float32)
    lm = reset_memory(lm, torch.from_numpy(done[-1]))
    for step in range(3):
        lo, lm, _ = lane(torch.from_numpy(y[step]), lm)
        so, sm, _ = scan(torch.from_numpy(y[step]), sm)
        _close(lo, so, FP32)


def test_banded_route_raises_naming_its_kernel():
    """The banded route runs (K7's plain version on CPU tensors; against JAX
    in tests/test_torch_banded_attention.py) and, on a device its kernel does
    not take, raises naming that kernel."""
    _, t = _attention_pair(4, False, True, None, "banded")
    out, memory, _ = t(torch.zeros(8, 2, 16), None, sequential=True)
    assert out.shape == (8, 2, 16) and memory["k_cache"].shape == (2, 2, 5, 8)
    with pytest.raises(RuntimeError, match="banded attention kernel"):
        t.to("meta")(torch.zeros(8, 2, 16, device="meta"), None, sequential=True)


def _layer_pair(norm_mode, dtype, input_dim=12, **kwargs):
    kwargs = dict(embed_dim=16, num_heads=2, window=4, norm_mode=norm_mode, compute_dtype=dtype, **kwargs)
    j = jca.CausalTransformerEncoderLayerFactory(**kwargs)(input_dim, None, jax.random.key(13))
    return j, _carry(j, tca.CausalTransformerEncoderLayerFactory(**kwargs)(input_dim, None))


@pytest.mark.parametrize("norm_mode", ["pre", "post", "none"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_matches_jax(norm_mode, dtype):
    j, t = _layer_pair(norm_mode, dtype)
    t.attention.sequence_mode = "lane"
    batch = 3
    x, done = _sequence(7, batch, 12, seed=14)
    jo, jm, _ = j(jnp.asarray(x), None, sequential=True, done=jnp.asarray(done))
    to, tm, _ = t(torch.from_numpy(x), None, sequential=True, done=torch.from_numpy(done))
    _close(to, jo, _tol(dtype))
    _memory_close(tm, jm, _tol(dtype))
    y = np.random.default_rng(15).standard_normal((batch, 12)).astype(np.float32)
    jo, _, _ = j(jnp.asarray(y), jm)
    to, _, _ = t(torch.from_numpy(y), tm)
    _close(to, jo, _tol(dtype))


@pytest.mark.parametrize("use_rope,use_alibi", [(True, False), (False, True)])
def test_sequential_next_token_matches_jax(use_rope, use_alibi):
    """``Sequential(layer, Mlp)``: the sequence pass that keeps the key context
    and the counterfactual-append pass, against JAX; then each next-token
    output against stepping the port's own layer from the pre-reset state."""
    kwargs = dict(embed_dim=16, num_heads=2, window=4, use_rope=use_rope, use_alibi=use_alibi, compute_dtype=None)
    jf = JaxSequentialFactory(factories=(jca.CausalTransformerEncoderLayerFactory(**kwargs),
                                         JaxMlpFactory(hidden_dims=(8,), activation="elu", ends_with_activation=True)))
    tf = SequentialFactory(factories=(tca.CausalTransformerEncoderLayerFactory(**kwargs),
                                      MlpFactory(hidden_dims=(8,), activation="elu", ends_with_activation=True)))
    j = jf(6, None, jax.random.key(16))
    t = _carry(j, tf(6, None))
    assert t.supports_next_token_eval and t.is_recurrent
    batch = 3
    x, done = _sequence(8, batch, 6, seed=17, p_done=0.25)
    y = np.random.default_rng(18).standard_normal(x.shape).astype(np.float32)
    jo, jm, jctx = j.sequential_with_ctx(jnp.asarray(x), None, jnp.asarray(done))
    to, tm, tctx = t.sequential_with_ctx(torch.from_numpy(x), None, torch.from_numpy(done))
    _close(to, jo, FP32)
    _memory_close(tm["0"], jm["0"], FP32)
    jn = j.eval_next_token(jnp.asarray(y), jctx)
    tn = t.eval_next_token(torch.from_numpy(y), tctx)
    _close(tn, jn, FP32)
    # Against the port's own step: y[t] right after x[t], from the ring as it
    # stood then (before the reset at t).
    memory = t.init_memory(batch)
    for step in range(x.shape[0]):
        _, memory, _ = t(torch.from_numpy(x[step]), memory)
        out, _, _ = t(torch.from_numpy(y[step]), memory)
        _close(out, tn[step], FP32)
        memory = reset_memory(memory, torch.from_numpy(done[step]))


def test_memory_helpers_keep_the_global_cursor():
    t = tca.CausalTransformerEncoderLayerFactory(embed_dim=16, num_heads=2, window=4, compute_dtype=None)(16, None)
    memory = t.init_memory(3)
    _, memory, _ = t(torch.randn(3, 16), memory)
    reset = reset_memory(memory, torch.tensor([[True], [False], [True]]))
    assert int(reset["cursor"]) == 1 and not reset["cache_mask"][0].any() and reset["cache_mask"][1].any()
    stored = storable_memory(reset, 3)
    assert stored["cursor"].shape == (3,) and stored["k_cache"].shape == memory["k_cache"].shape
    # A stored (broadcast) cursor reads back as the global one.
    x = torch.randn(3, 16)
    torch.testing.assert_close(t(x, stored)[0], t(x, reset)[0], rtol=0, atol=0)


def test_orthogonal_initialization_reaches_every_linear_of_the_transformer():
    """The set of re-initialized paths equals the JAX hook's
    ``map_linear_layers`` paths, for the transformer entry's actor and critic
    (input projection, q/k/v/out, FFN up/down, the MLP head, the mean head)."""
    from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment
    from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv

    small = dict(embed_dim=16, num_heads=2, attention_window=4, mlp_hidden_dims=(16,), normalize_observation=False,
                 desired_kl_divergence=None)
    jf = jax_get_experiment("Velocity-Flat", "transformer_ppo").make_agent_factory()
    tf = get_experiment("Velocity-Flat", "transformer_ppo").make_agent_factory()
    for f in (jf, tf):
        for k, v in small.items():
            setattr(f, k, v)
    jax_agent = jf(JaxEnv(num_instances=8, observation_dim=10, action_dim=3).spec)
    agent = tf(VelocityLocomotionEnv(num_instances=8, observation_dim=10, action_dim=3, device="cpu").spec,
               device="cpu")
    hook = agent.get_hook("module_initialization")
    for net in ("actor", "critic"):
        jax_paths = []
        map_linear_layers(getattr(jax_agent.state, net), lambda path, linear: jax_paths.append(path) or linear)
        paths = hook._reinit(getattr(agent, net), torch.Generator().manual_seed(0), {})
        assert sorted(paths) == sorted(jax_paths) and len(paths) >= 8
