"""QK-norm on the causal transformer and the one-lane-call pair pass
(``CUSRL_TPU_PAIR_CONCAT=1``), the port against the JAX package on the CPU.

QK-norm: a QK-normed ``CausalTransformerEncoderLayer`` keeps the modular
route on both sides (neither takes the fused block, even under
``CUSRL_TPU_FUSED_TRANSFORMER=force``).  In sequence mode the port's lane
route (K3's plain version) against JAX's lane route running its Pallas
kernels in interpret mode (``use_pallas=True``, forward and backward), in
bf16: outputs, the ring (normed, un-rotated keys) and every parameter's
gradient; then the next-token pass (K6's plain version against JAX's XLA
route), and single steps across the ring against JAX's step in fp32 and
bf16.  Then two whole updates of a
small QK-normed transformer agent, the preset's backbone with ``qk_norm=True``
on both sides.

The pair pass: the port's concatenated pass against JAX's (both under
``force``: the port's K5 plain versions, JAX's Pallas pair kernels in
interpret mode), outputs, memories and gradients; and against the port's
own two-call pass, which it equals bit for bit (each environment's attention
is independent).

Tolerances: fp32 1e-5 on outputs (summation order), gradients per leaf 1e-4
of the leaf's largest element; bf16 the layer tolerances of
``tests/test_torch_fused_block.py`` (outputs and memories 5e-2, gradients
atol 2e-2 / rtol 8e-2: bf16 roundings that fall differently and carry through
LayerNorm and the FFN).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.kernels import lane_attention as jla
from cusrl_tpu.nn.module import causal_attn as jca
from cusrl_tpu_torch.nn.base import reset_memory
from cusrl_tpu_torch.nn.module import causal_attn as tca
from cusrl_tpu_torch.utils.interop import load_jax_params

FP32 = dict(rtol=1e-5, atol=1e-5)
LAYER_OUT = dict(rtol=5e-2, atol=5e-2)
LAYER_GRAD = dict(rtol=8e-2, atol=2e-2)
IN_DIM = 12


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _close_memory(got, want, tol):
    for key in ("k_cache", "v_cache", "cache_mask", "cursor"):
        _close(got[key], want[key], tol if key.endswith("cache") else dict(rtol=0, atol=0), key)


def _grad_close(got, want, dtype, path):
    if dtype is None:
        scale = np.abs(_np(want)).max()
        assert np.abs(_np(got) - _np(want)).max() <= 1e-4 * scale, path
    else:
        _close(got, want, LAYER_GRAD, path)


def _layer_pair(dtype, seed=0, qk_norm=True):
    kwargs = dict(embed_dim=16, num_heads=2, window=4, ff_dim=32, qk_norm=qk_norm, compute_dtype=dtype)
    j = jca.CausalTransformerEncoderLayerFactory(**kwargs)(IN_DIM, None, jax.random.key(seed))
    if qk_norm:  # non-unit norm scales, so a scale that is not applied shows
        rng = np.random.default_rng(seed + 100)
        mha = j.attention.mha
        j = dataclasses.replace(j, attention=dataclasses.replace(j.attention, mha=dataclasses.replace(
            mha, q_norm=mha.q_norm.replace(scale=jnp.asarray(rng.random(8) + 0.5, jnp.float32)),
            k_norm=mha.k_norm.replace(scale=jnp.asarray(rng.random(8) + 0.5, jnp.float32)))))
    t = tca.CausalTransformerEncoderLayerFactory(**kwargs)(IN_DIM, None)
    return j, load_jax_params(t, {p: np.asarray(v) for p, v in tree_paths(j)})


def _jax_lane_kernels(monkeypatch):
    """JAX's lane route on its Pallas kernels (interpret mode on the CPU)."""
    window, next_token = jla.lane_window_attention, jla.lane_next_token_attention
    monkeypatch.setattr(jla, "lane_window_attention", lambda *a, **k: window(*a, **{**k, "use_pallas": True}))
    monkeypatch.setattr(jla, "lane_next_token_attention",
                        lambda *a, **k: next_token(*a, **{**k, "use_pallas": True}))


def _inputs(t_len, batch, seed, p_done=0.2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t_len, batch, IN_DIM)).astype(np.float32),
            rng.random((t_len, batch, 1)) < p_done)


def _warm(j, t, batch, seed):
    """Three steps with resets: a part-full ring at cursor 3."""
    from cusrl_tpu.nn.base import reset_memory as jax_reset

    x, done = _inputs(3, batch, seed)
    jm, tm = j.init_memory(batch), t.init_memory(batch)
    jstep = jax.jit(lambda layer, a, m: layer(a, m)[1])
    with torch.no_grad():
        for step in range(3):
            jm = jax_reset(jstep(j, jnp.asarray(x[step]), jm), jnp.asarray(done[step]))
            tm = reset_memory(t(torch.from_numpy(x[step]), tm)[1], torch.from_numpy(done[step]))
    return jm, tm


def test_qk_normed_layer_on_the_lane_route_matches_jax_pallas(monkeypatch):
    dtype = "bfloat16"
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    _jax_lane_kernels(monkeypatch)
    j, t = _layer_pair(dtype)
    j = dataclasses.replace(j, attention=dataclasses.replace(j.attention, sequence_mode="lane"))
    t.attention.sequence_mode = "lane"
    t_len, batch = 8, 6
    x, done = _inputs(t_len, batch, 1)
    assert not j._fused_eligible(jnp.asarray(x), True) and not t._fused_eligible(torch.from_numpy(x), True)
    assert not t._fused_eligible(torch.from_numpy(x[0]), False)
    jm, tm = _warm(j, t, batch, 2)
    tgt = np.random.default_rng(3).standard_normal((t_len, batch, 16)).astype(np.float32)

    def jloss(layer):
        out, mem, _ = layer(jnp.asarray(x), jm, sequential=True, done=jnp.asarray(done))
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt)), (out, mem)

    (_, (jout, jmem)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out, tmem, _ = t(torch.from_numpy(x), tm, sequential=True, done=torch.from_numpy(done))
    tol = FP32 if dtype is None else LAYER_OUT
    _close(out, jout, tol)
    _close_memory(tmem, jmem, tol)
    (out.float() - torch.from_numpy(tgt)).square().mean().backward()
    given = dict(tree_paths(jgrads))
    assert {"attention.mha.q_norm.scale", "attention.mha.k_norm.scale"} <= set(given)
    for path, param in t.named_parameters():
        _grad_close(param.grad, given[path], dtype, path)

    # The next-token pass (K6's plain version) from the value pass's context,
    # against JAX's XLA route (its kernels' interpret mode compiles for long
    # here; tests/test_torch_lane_attention.py holds K6 to them).
    monkeypatch.undo()
    y = np.random.default_rng(4).standard_normal((t_len, batch, IN_DIM)).astype(np.float32)
    jout, _, jctx = jax.jit(type(j).sequential_with_ctx)(j, jnp.asarray(x), jm, jnp.asarray(done))
    jnext = jax.jit(type(j).eval_next_token)(j, jnp.asarray(y), jctx)
    with torch.no_grad():
        out, _, ctx = t.sequential_with_ctx(torch.from_numpy(x), tm, torch.from_numpy(done))
        nxt = t.eval_next_token(torch.from_numpy(y), ctx)
    _close(out, jout, tol)
    _close(nxt, jnext, tol)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_qk_normed_layer_steps_match_jax_across_the_ring(dtype):
    j, t = _layer_pair(dtype, seed=5)
    batch = 4
    xs, done = _inputs(11, batch, 6, p_done=0.15)
    jm, tm = j.init_memory(batch), t.init_memory(batch)
    from cusrl_tpu.nn.base import reset_memory as jax_reset

    jstep = jax.jit(lambda layer, a, m: layer(a, m)[:2])
    tol = FP32 if dtype is None else LAYER_OUT
    with torch.no_grad():
        for step in range(xs.shape[0]):
            jout, jm = jstep(j, jnp.asarray(xs[step]), jm)
            out, tm, _ = t(torch.from_numpy(xs[step]), tm)
            _close(out, jout, tol, f"step {step}")
            jm, tm = jax_reset(jm, jnp.asarray(done[step])), reset_memory(tm, torch.from_numpy(done[step]))
    _close_memory(tm, jm, tol)
    assert int(tm["cursor"]) == xs.shape[0] % 5


def _qk_norm_backbones(monkeypatch):
    """The transformer preset's backbones with ``qk_norm=True`` on every
    encoder layer, on both sides (the preset has no such field)."""
    from cusrl_tpu.preset.ppo import TransformerPpoAgentFactory as JaxFactory
    from cusrl_tpu_torch.preset.ppo import TransformerPpoAgentFactory

    for cls, layer_cls in ((JaxFactory, jca.CausalTransformerEncoderLayerFactory),
                           (TransformerPpoAgentFactory, tca.CausalTransformerEncoderLayerFactory)):
        original = cls._backbone_factory

        def patched(self, hidden_dims, original=original, layer_cls=layer_cls):
            factory = original(self, hidden_dims)
            if isinstance(factory, layer_cls):
                return dataclasses.replace(factory, qk_norm=True)
            factory.factories = tuple(dataclasses.replace(f, qk_norm=True) if isinstance(f, layer_cls) else f
                                      for f in factory.factories)
            return factory

        monkeypatch.setattr(cls, "_backbone_factory", patched)


def test_qk_normed_transformer_updates_match_jax(monkeypatch):
    """Two whole updates of the zoo's transformer entry at small widths (embed
    32, 2 heads, window 4, T = 8, N = 128) with QK-norm, in fp32 on the lane
    route (K3, K6 plain versions): every metric of each update, then every
    parameter and hook state, at the tolerances of
    ``tests/test_torch_update_transformer.py``'s fp32 update."""
    from tests import test_torch_update_transformer as tut
    from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
    from cusrl_tpu.utils import misc as jax_misc
    from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.utils.config import CONFIG
    from cusrl_tpu_torch.utils.interop import load_jax_state

    n = 128
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    tut._kernel_routes(monkeypatch, False)
    _qk_norm_backbones(monkeypatch)
    jf, tf = tut._factories()
    jax_agent = jf(JaxEnv(num_instances=n, observation_dim=tut.OBS, action_dim=tut.ACT).spec)
    agent = tf(VelocityLocomotionEnv(num_instances=n, observation_dim=tut.OBS, action_dim=tut.ACT,
                                     device="cpu").spec, device="cpu")
    assert agent.actor.backbone.members[0].attention.mha.q_norm is not None
    rng = np.random.default_rng(7)
    tut._warm_memories(jax_agent, rng, n)
    state = jax_agent.state_dict()
    load_jax_state(agent, state["agent_state"], actor_memory=state["actor_memory"])
    metric_tol, param_tol, state_tol = tut.FP32_TOL
    update = jax.jit(jax_agent.update_body)
    for index in range(2):
        rollout = tut._rollout(jax_agent, rng, tut.T, n)
        jax_rollout = jax.tree.map(jnp.asarray, rollout)
        key = jax.random.key(5 + index)
        _, _, indices = jax_agent.sampler.make_plan(key, tut.T, n, jax_rollout)
        new_state, jax_metrics = update(jax_agent.state, jax_rollout, key)
        jax_agent.state = new_state
        metrics = agent.update_body(tut._to_torch(rollout),
                                    epoch_perms=tut._tile_perms(indices, jax_agent.sampler.num_epochs, False))
        assert set(metrics) == set(jax_metrics)
        for name, value in jax_metrics.items():
            np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=f"update {index}: {name}",
                                       **metric_tol)
    new = {p: np.asarray(v, np.float32) for p, v in tree_paths(jax_agent.state)}
    params = dict(agent.model.named_parameters())
    assert any(p.endswith("q_norm.scale") for p in params)
    for path, param in params.items():
        np.testing.assert_allclose(param.detach().numpy(), new[path], err_msg=path, **param_tol)
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            np.testing.assert_allclose(tensor.float().numpy(), new[f"hooks.{index}.{name}"], err_msg=name,
                                       **state_tol)


# ---------------------------------------------------------------------------
# The one-lane-call pair pass
# ---------------------------------------------------------------------------


def _fused_pair_inputs(seed):
    (ja, ta), (jc, tc) = _layer_pair("bfloat16", seed, qk_norm=False), _layer_pair("bfloat16", seed + 1,
                                                                                   qk_norm=False)
    t_len, batch = 8, 5
    xa, done = _inputs(t_len, batch, seed + 2)
    xc, _ = _inputs(t_len, batch, seed + 3)
    return (ja, ta), (jc, tc), xa, xc, done


def _ring(j, batch, seed, cursor=3):
    rng = np.random.default_rng(seed)
    mem = j.init_memory(batch)
    jmem = {
        "k_cache": jnp.asarray(rng.standard_normal(mem["k_cache"].shape), jnp.bfloat16),
        "v_cache": jnp.asarray(rng.standard_normal(mem["v_cache"].shape), jnp.bfloat16),
        "cache_mask": jnp.asarray(rng.random(mem["cache_mask"].shape) < 0.6, jnp.float32),
        "cursor": jnp.asarray(cursor, jnp.int32),
    }
    tmem = {k: torch.from_numpy(_np(v)).to(torch.bfloat16) for k, v in jmem.items() if k.endswith("cache")}
    tmem["cache_mask"] = torch.from_numpy(_np(jmem["cache_mask"]))
    tmem["cursor"] = torch.tensor(cursor)
    return jmem, tmem


def test_concatenated_pair_pass_matches_jax_and_the_two_call_pass(monkeypatch):
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    monkeypatch.setenv("CUSRL_TPU_PAIR_CONCAT", "1")
    (ja, ta), (jc, tc), xa, xc, done = _fused_pair_inputs(10)
    batch = xa.shape[1]
    jmem_a, tmem_a = _ring(ja, batch, 20)
    jmem_c, tmem_c = _ring(jc, batch, 21)
    tgt = np.random.default_rng(22).standard_normal((2, *xa.shape[:2], 16)).astype(np.float32)

    def jloss(layers):
        la, lc, ma, mc = jca.fused_pair_sequence(*layers, jnp.asarray(xa), jnp.asarray(xc), jmem_a, jmem_c,
                                                 jnp.asarray(done))
        loss = jnp.mean(jnp.square(la.astype(jnp.float32) - tgt[0])) + jnp.mean(
            jnp.square(lc.astype(jnp.float32) - tgt[1]))
        return loss, (la, lc, ma, mc)

    batches = []  # each side's sequence_core calls, by environment count
    for module in (jca, tca):
        core = module.CausalMultiheadSelfAttention.sequence_core
        monkeypatch.setattr(module.CausalMultiheadSelfAttention, "sequence_core",
                            lambda self, *a, core=core, **k: batches.append(a[-1]) or core(self, *a, **k))
    (_, jouts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))((ja, jc))
    assert batches == [2 * batch]

    def port(concat: str):
        monkeypatch.setenv("CUSRL_TPU_PAIR_CONCAT", concat)
        for layer in (ta, tc):
            layer.zero_grad()
        outs = tca.fused_pair_sequence(ta, tc, torch.from_numpy(xa), torch.from_numpy(xc), tmem_a, tmem_c,
                                       torch.from_numpy(done))
        loss = sum((o.float() - torch.from_numpy(g)).square().mean() for o, g in zip(outs[:2], tgt))
        loss.backward()
        return outs, [{n: p.grad.clone() for n, p in layer.named_parameters()} for layer in (ta, tc)]

    outs, grads = port("1")
    assert batches == [2 * batch] * 2
    for got, want in zip(outs[:2], jouts[:2]):
        _close(got, want, LAYER_OUT)
    for got, want in zip(outs[2:], jouts[2:]):
        _close_memory(got, want, LAYER_OUT)
    for layer_grads, jax_layer in zip(grads, jgrads):
        given = dict(tree_paths(jax_layer))
        for name, grad in layer_grads.items():
            _close(grad, given[name], LAYER_GRAD, name)
    # The two-call pass gives the same bits: each environment's attention is independent.
    ref_outs, ref_grads = port("0")
    assert batches == [2 * batch] * 2 + [batch] * 2
    for got, want in zip(outs, ref_outs):
        for a, b in (zip(got.values(), want.values()) if isinstance(got, dict) else ((got, want),)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for layer_grads, layer_ref in zip(grads, ref_grads):
        for name in layer_grads:
            torch.testing.assert_close(layer_grads[name], layer_ref[name], rtol=0, atol=0, msg=name)
