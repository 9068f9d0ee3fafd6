"""The port's banded window attention (K7; its plain version on the CPU)
against the JAX package's banded reference and its Pallas kernel in interpret
mode, and the long-sequence routes that reach it: the attention module's
``banded`` mode, ``sequence_core`` of the fused-block route for T > 64, and
one whole transformer update at T = 72 on that route.

Inputs are made with numpy from a seed and fed to both sides, in the JAX
layout: q ``[N, H, T, D]``, k/v ``[N, H, W+T, D]``, q_seg ``[N, T]``,
k_seg/k_valid ``[N, W+T]``.  Tolerances: fp32 inputs rtol 1e-4 / atol 1e-5
(the same fp32 arithmetic summed in another order: the JAX tests' own limits,
tests/test_banded_attention.py); the layer and the update on the fused route
keep the limits of tests/test_torch_fused_block.py and
tests/test_torch_update_transformer.py, for bf16 roundings that fall
differently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.kernels import banded_attention as jba
from cusrl_tpu.nn.layer import mha as jmha
from cusrl_tpu.nn.module import causal_attn as jca
from cusrl_tpu_torch.nn.kernels import banded_attention as tba
from cusrl_tpu_torch.nn.layer import mha as tmha
from cusrl_tpu_torch.nn.module import causal_attn as tca
from test_torch_fused_block import LAYER_GRAD, LAYER_OUT, _close, _close_memory, _inputs, _layer_pair, _memories, _t
from test_torch_transformer import _carry
from test_torch_update_transformer import _update_matches_jax

TOL = dict(rtol=1e-4, atol=1e-5)


def _make(t_len, window, batch=2, heads=2, head_dim=8, seed=0, invalid_rows=False):
    rng = np.random.default_rng(seed)
    s_len = window + t_len
    q = rng.standard_normal((batch, heads, t_len, head_dim)).astype(np.float32)
    k = rng.standard_normal((batch, heads, s_len, head_dim)).astype(np.float32)
    v = rng.standard_normal((batch, heads, s_len, head_dim)).astype(np.float32)
    done = rng.random((batch, t_len)) < 0.05
    q_seg = np.cumsum(np.pad(done.astype(np.int32), ((0, 0), (1, 0)))[:, :-1], axis=1).astype(np.int32)
    k_seg = np.concatenate([np.zeros((batch, window), np.int32), q_seg], axis=1)
    k_valid = np.concatenate([(rng.random((batch, window)) < 0.5).astype(np.int32),
                              np.ones((batch, t_len), np.int32)], axis=1)
    if invalid_rows:  # env 0 sees no valid key at all; env 1 only its cache
        k_valid[0] = 0
        k_valid[1, window:] = 0
        k_valid[1, :window] = 1
    return q, k, v, q_seg, k_seg, k_valid


def _slopes(use_alibi, heads=2):
    return (0.5, 0.125)[:heads] if use_alibi else None


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_outputs(t_len, window, use_alibi):
    """JAX's banded reference (at ``block_q`` 16 and 128) and its Pallas
    kernel in interpret mode (which always takes 128-query blocks)."""
    arrays = _jax(_make(t_len, window, seed=t_len + window))
    slopes = None if not use_alibi else jnp.asarray(_slopes(True), jnp.float32)
    static = dict(window=window, slopes=slopes)
    refs = {bq: np.asarray(jax.jit(functools.partial(jba._banded_reference, block_q=bq, **static))(*arrays))
            for bq in (16, 128)}
    pallas = jax.jit(functools.partial(jba._banded_pallas, block_q=128, interpret=True, **static))(*arrays)
    return refs, np.asarray(pallas)


@pytest.mark.parametrize("block_q", [16, 128])
@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("t_len,window", [(72, 16), (72, 48), (200, 16), (200, 48)])
def test_banded_plain_matches_reference_and_pallas(t_len, window, use_alibi, block_q):
    """T = 72 and 200 (not multiples of the 128-query block; 200 spans two),
    windows below the block, ALiBi on and off, two banding plans."""
    arrays = _make(t_len, window, seed=t_len + window)
    got = tba.banded_plain(*_torch(arrays), window, _slopes(use_alibi), block_q)
    refs, pallas = _jax_outputs(t_len, window, use_alibi)
    assert got.dtype == torch.float32 and got.shape == arrays[0].shape
    np.testing.assert_allclose(got.numpy(), refs[block_q], **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    with torch.no_grad():
        wrapped = tba.banded_window_attention(*_torch(arrays), window=window, slopes=_slopes(use_alibi),
                                              block_q=block_q)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("window", [4, 160])
def test_rows_without_a_valid_key_are_exactly_zero(window):
    """W = 160 is wider than the 128-query block: a band of three blocks."""
    t_len = 70
    arrays = _make(t_len, window, seed=3, invalid_rows=True)
    expected = jba._banded_reference(*_jax(arrays), window, None, 128)
    q, k, v, *masks = _torch(arrays)
    for t in (q, k, v):
        t.requires_grad_()
    out = tba.banded_window_attention(q, k, v, *masks, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), **TOL)
    assert not out[0].any()  # env 0: no valid key anywhere
    assert not out[1, :, window:].any()  # env 1: queries past its cache see nothing
    out.sum().backward()
    assert torch.isfinite(q.grad).all() and not q.grad[0].any()


@pytest.mark.parametrize("use_alibi", [False, True])
def test_gradients_match_the_custom_vjp(use_alibi):
    """q, k and v gradients (fp32) against ``jax.grad`` through the JAX
    package's custom VJP (``_banded_op_bwd``: recompute through the
    reference); the port recomputes through ``banded_plain`` the same way."""
    window, t_len = 12, 77
    arrays = _make(t_len, window, seed=5)
    slopes = _slopes(use_alibi)
    jq, jk, jv, *masks = _jax(arrays)
    jslopes = None if slopes is None else jnp.asarray(slopes, jnp.float32)

    def loss(q, k, v):
        out = jba.banded_window_attention(q, k, v, *masks, window=window, slopes=jslopes, use_pallas=False)
        return jnp.sum(jnp.sin(out))

    expected = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v, *tmasks = _torch(arrays)
    for t in (q, k, v):
        t.requires_grad_()
    tba.banded_window_attention(q, k, v, *tmasks, window=window, slopes=slopes).sin().sum().backward()
    for got, want in zip((q.grad, k.grad, v.grad), expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_gradients_come_back_in_the_inputs_dtype():
    window, t_len = 8, 70
    q, k, v, *masks = _torch(_make(t_len, window, seed=6))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    out = tba.banded_window_attention(*leaves, *masks, window=window)
    assert out.dtype == torch.float32
    out.sum().backward()
    ref = [t.detach().float().requires_grad_() for t in leaves]
    tba.banded_plain(*ref, *masks, window).sum().backward()
    for a, b in zip(leaves, ref):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float(), b.grad.to(torch.bfloat16).float(), rtol=0, atol=0)


def test_wrapper_counts_no_launch_and_refuses_what_the_kernel_does_not_take():
    window = 4
    q, k, v, *masks = _torch(_make(70, window, seed=7))
    tba.reset_launch_counts()
    with torch.no_grad():
        primal = tba.banded_window_attention(q, k, v, *masks, window=window)
    with_grad = tba.banded_window_attention(q.requires_grad_(), k, v, *masks, window=window)
    torch.testing.assert_close(primal, with_grad.detach(), rtol=0, atol=0)
    with_grad.sum().backward()
    assert tba.LAUNCHES == {"K7f": 0}
    with pytest.raises(TypeError, match="sequence of floats"):
        tba.banded_window_attention(q, k, v, *masks, window=window, slopes=torch.ones(2))
    meta = [t.to("meta") for t in (q, k, v, *masks)]
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tba.banded_window_attention(*meta, window=window)
    with pytest.raises(ValueError, match="W\\+T"):
        tba._launch_fwd(q, k[:, :, 1:], v[:, :, 1:], *masks, window, None)
    with pytest.raises(ValueError, match="head dims"):
        tba._launch_fwd(q[..., :6], k[..., :6], v[..., :6], *masks, window, None)
    with pytest.raises(ValueError, match="too wide"):
        tba._launch_fwd(q, *(torch.zeros(2, 2, 4000 + 70, 8) for _ in range(2)),
                        masks[0], *(torch.zeros(2, 4070, dtype=torch.int32) for _ in range(2)), 4000, None)


def test_kernel_query_block_fits_shared_memory():
    """The kernel's query block (``fwd_plan``): on the tensor-core path (bf16,
    D >= 16) 128 queries at the long-rollout shape, fewer for a short
    sequence (a multiple of 16); on the lanes path (fp32) 256 / lanes; on
    either, halved while the band does not fit."""
    plan = lambda t_len, window, dim, dtype: tba.fwd_plan(t_len, window, dim, dtype)["block_q"]
    assert plan(256, 16, 32, torch.bfloat16) == 128
    assert plan(70, 16, 32, torch.bfloat16) == 80 and plan(20, 16, 32, torch.bfloat16) == 32
    assert plan(256, 160, 64, torch.float32) == 64
    assert plan(256, 400, 64, torch.float32) == 32
    assert (tba.fwd_plan(256, 400, 64, torch.float32)["smem_bytes"] <= tba.MAX_SMEM
            < (64 + 400) * (2 * 64 * 4 + 8))
    assert plan(256, 600, 64, torch.bfloat16) == 64
    assert plan(256, 2000, 64, torch.float32) == 0


# ---------------------------------------------------------------------------
# The attention module's banded mode
# ---------------------------------------------------------------------------


def _attention_memories(batch, heads, window, head_dim, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, heads, window + 1, head_dim)
    arrays = dict(k_cache=rng.standard_normal(shape).astype(np.float32),
                  v_cache=rng.standard_normal(shape).astype(np.float32),
                  cache_mask=(rng.random((batch, window + 1)) < 0.6).astype(np.float32))
    jmem = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmem["cursor"] = jnp.asarray(3, jnp.int32)
    tmem = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tmem["cursor"] = torch.tensor(3)
    return jmem, tmem


@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("t_len", [72, 37])
def test_banded_mode_matches_jax_and_the_other_modes(use_alibi, t_len):
    """``sequence_mode="banded"`` against JAX's banded module (its reference
    on the CPU), and against the port's ``batched`` and ``scan`` modes:
    outputs and the final ring, fp32."""
    window, batch, embed, heads = 8, 5, 32, 4
    j = jca.CausalMultiheadSelfAttention(mha=jmha.MultiheadAttention.init(jax.random.PRNGKey(0), embed, heads,
                                                                           rope=True),
                                         window=window, use_alibi=use_alibi, input_dim=embed, sequence_mode="banded")
    rng = np.random.default_rng(t_len)
    x = rng.standard_normal((t_len, batch, embed)).astype(np.float32)
    done = rng.random((t_len, batch, 1)) < 0.08
    jmem, tmem = _attention_memories(batch, heads, window, embed // heads, seed=1)
    jout, jm, _ = j(jnp.asarray(x), jmem, sequential=True, done=jnp.asarray(done))
    outputs = {}
    mha = _carry(j.mha, tmha.MultiheadAttention(embed, heads, rope=True))
    for mode in ("banded", "batched", "scan"):
        t = tca.CausalMultiheadSelfAttention(mha, window=window, use_alibi=use_alibi, input_dim=embed,
                                             sequence_mode=mode)
        with torch.no_grad():
            outputs[mode] = t(torch.from_numpy(x), tmem, sequential=True, done=torch.from_numpy(done))[:2]
    out, mem = outputs["banded"]
    _close(out, jout, TOL)
    for key in jm:
        _close(mem[key], jm[key], TOL, key)
    _close(out, outputs["batched"][0], TOL)
    _close(out, outputs["scan"][0], TOL)
    for key in ("k_cache", "v_cache", "cache_mask", "cursor"):
        _close(mem[key], outputs["batched"][1][key], TOL, key)


def test_auto_mode_resolves_as_the_jax_rule():
    """``auto`` takes the banded route where the JAX rule does (the key band
    at most half the keys), on the CPU as on the card; the lane route only
    for CUDA tensors with T <= 64."""
    t = tca.CausalMultiheadSelfAttention(tmha.MultiheadAttention(16, 2), window=16, input_dim=16)
    resolve = lambda t_len: t._resolve_mode(torch.zeros(t_len, 2, 16), False)
    assert resolve(256) == "batched"  # band 256 > (16 + 256) / 2
    assert resolve(512) == "banded" and resolve(600) == "banded"
    assert resolve(24) == "batched" and resolve(72) == "batched"
    t.sequence_mode = "banded"
    assert resolve(24) == "banded" and t._resolve_mode(torch.zeros(8, 2, 16), True) == "banded"


# ---------------------------------------------------------------------------
# The fused-block route for T > 64
# ---------------------------------------------------------------------------

def test_sequence_core_long_sequence_matches_jax(monkeypatch):
    """``sequential_with_ctx`` and ``eval_next_token`` on the fused route under
    ``force`` at T = 72 (``sequence_core`` through the banded attention, the
    next-token pass through its plain version) against JAX under ``force``:
    outputs, the final ring, the next-token context and the next-token pass."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    j, t = _layer_pair(seed=2)
    t_len, batch = 72, 5
    x, done = _inputs(t_len, batch, 30)
    y = np.random.default_rng(31).standard_normal(x.shape).astype(np.float32)
    jmem, tmem = _memories(j, batch, 32)
    jout, jm, jctx = jax.jit(type(j).sequential_with_ctx)(j, jnp.asarray(x), jmem, jnp.asarray(done))
    jnext = jax.jit(type(j).eval_next_token)(j, jnp.asarray(y), jctx)
    calls = []
    monkeypatch.setattr(tca, "banded_window_attention",
                        lambda *a, **k: calls.append(a[0].shape) or tba.banded_window_attention(*a, **k))
    with torch.no_grad():
        out, tm, ctx = t.sequential_with_ctx(_t(x), tmem, torch.from_numpy(done))
        nxt = t.eval_next_token(_t(y), ctx)
    assert calls == [(batch, 2, t_len, 16)]
    _close(out, jout, LAYER_OUT)
    _close_memory(tm, jm, LAYER_OUT)
    for name, got, want in zip(("k_rot", "v_all", "k_valid", "k_seg", "q_seg"), ctx, jctx):
        _close(got, want, LAYER_OUT if name in ("k_rot", "v_all") else dict(rtol=0, atol=0), name)
    _close(nxt, jnext, LAYER_OUT)


def test_fused_long_sequence_gradients_match_jax(monkeypatch):
    """Sequence mode under ``force`` at T = 72 on both sides: outputs and
    every parameter's gradient, through the banded attention's recomputing
    backward."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    j, t = _layer_pair(seed=1)
    t_len, batch = 72, 3
    x, done = _inputs(t_len, batch, 20)
    jmem, tmem = _memories(j, batch, 21)
    tgt = np.random.default_rng(22).standard_normal((t_len, batch, 32)).astype(np.float32)

    def jloss(layer):
        out, mem, _ = layer(jnp.asarray(x), jmem, sequential=True, done=jnp.asarray(done))
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    out, _, _ = t(_t(x), tmem, sequential=True, done=torch.from_numpy(done))
    _close(out, jout, LAYER_OUT)
    ((out.float() - _t(tgt)).square().mean()).backward()
    given = dict(tree_paths(jgrads))
    for path, param in t.named_parameters():
        _close(param.grad, given[path], LAYER_GRAD, path)


def test_next_token_pass_takes_the_plain_version_for_long_sequences(monkeypatch):
    """``eval_next_core`` sends T > 64 to ``next_token_plain`` (JAX
    ``causal_attn.py:721``: the Pallas kernel only for T <= 64) and shorter
    sequences to the K6 wrapper."""
    attention = tca.CausalMultiheadSelfAttention(tmha.MultiheadAttention(16, 2), window=4, input_dim=16)
    used = []
    monkeypatch.setattr(tca, "lane_next_token_attention", lambda *a, **k: used.append("K6") or a[0].float())
    monkeypatch.setattr(tca, "next_token_plain", lambda *a, **k: used.append("plain") or a[0].float())
    for t_len in (64, 65, 256):
        q, k, v, *masks = _torch(_make(t_len, 4, seed=t_len))
        attention.eval_next_core(q, q, q, (k, v, masks[2], masks[1], masks[0]))
    assert used == ["K6", "plain", "plain"]


def test_long_rollout_update_on_the_fused_route_matches_jax(monkeypatch):
    """One whole update of the transformer entry at small widths with 72-step
    rollouts (16 environments, 4 per minibatch) on the fused route under
    ``force`` on both sides: every sequence pass goes through the banded
    attention and the bootstrap's next-token pass through its plain
    version."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    _update_matches_jax("bfloat16", monkeypatch, t_len=72, n=16)
