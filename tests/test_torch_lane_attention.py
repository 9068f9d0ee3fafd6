"""The port's lane attention (K3 forward and backward, K6; plain versions on
the CPU) against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and fed to both, in the JAX layout:
q ``[N, H, T, D]``, k/v ``[N, H, W+T, D]``, q_seg ``[N, T]``, k_seg/k_valid
``[N, W+T]``.  Interpret mode simulates every band op, so the shapes are
small (T = 8 or a ragged 7, W = 4 or 5), as in tests/test_lane_attention.py.
Tolerances: fp32 inputs rtol 1e-4 / atol 1e-5 (the same fp32 arithmetic
summed in another order, the JAX test's own limits); bf16 inputs give fp32
outputs from the same bf16 values (same limits) and gradients cast to bf16
(one bf16 rounding, 1e-2 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.kernels import lane_attention as jla
from cusrl_tpu_torch.nn.kernels import lane_attention as tla

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_GRAD_TOL = dict(rtol=1e-2, atol=1e-2)


def _make(t_len=8, window=4, batch=5, heads=2, head_dim=8, seed=0, invalid_rows=False):
    rng = np.random.default_rng(seed)
    s_len = window + t_len
    q = rng.standard_normal((batch, heads, t_len, head_dim)).astype(np.float32)
    k = rng.standard_normal((batch, heads, s_len, head_dim)).astype(np.float32)
    v = rng.standard_normal((batch, heads, s_len, head_dim)).astype(np.float32)
    done = rng.random((batch, t_len)) < 0.15
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
    return (0.5, 0.25)[:heads] if use_alibi else None


def _torch(arrays, dtype=torch.float32):
    q, k, v, q_seg, k_seg, k_valid = arrays
    return ([torch.tensor(a, dtype=dtype) for a in (q, k, v)]
            + [torch.from_numpy(a) for a in (q_seg, k_seg, k_valid)])


def _jax(arrays, dtype=jnp.float32):
    q, k, v, q_seg, k_seg, k_valid = arrays
    return [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(a) for a in (q_seg, k_seg, k_valid)]


@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("t_len,window", [(8, 4), (7, 5)])
def test_lane_forward_matches_pallas(use_alibi, t_len, window):
    arrays = _make(t_len=t_len, window=window)
    slopes = _slopes(use_alibi)
    expected = jla.lane_window_attention(*_jax(arrays), window=window, slopes=slopes, use_pallas=True)
    with torch.no_grad():
        got = tla.lane_window_attention(*_torch(arrays), window=window, slopes=slopes)
    assert got.dtype == torch.float32 and got.shape == arrays[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("invalid_rows", [False, True])
@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("save", [False, True])
def test_lane_forward_variants_match_the_pallas_kernel(save, use_alibi, invalid_rows):
    """K3f's plain version, primal and saving the probabilities, against
    ``_lane_pallas_fwd`` in interpret mode (its output and, saving, its
    weights ``[H, W+1, T8, N_pad]`` in the port's ``[N, H, T, W+1]``
    layout), with and without ALiBi, with rows that see no valid key (0)."""
    t_len, window = 7, 5
    arrays = _make(t_len=t_len, window=window, seed=4 + invalid_rows, invalid_rows=invalid_rows)
    slopes = _slopes(use_alibi)
    q, k, v, q_seg, k_seg, k_valid = _jax(arrays)
    n = q.shape[0]
    em = jla._to_lane_layout(q, k, v, q_seg, k_seg, k_valid, window, 128)[:6]
    out_em, weights = jla._lane_pallas_fwd(*em, window, 1.0 / np.sqrt(q.shape[-1]), slopes, 128, True, save)
    got, probs = tla.lane_fwd_plain(*_torch(arrays), window, slopes, save)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.transpose(out_em, (3, 0, 2, 1))[:n, :, :t_len]), **TOL)
    assert (probs is None) != save and (weights is None) != save
    if save:
        np.testing.assert_allclose(probs.numpy(), np.asarray(jnp.transpose(weights, (3, 0, 2, 1))[:n, :, :t_len]),
                                   **TOL)
    if invalid_rows:
        assert not got[0].any() and (probs is None or not probs[0].any())


@pytest.mark.parametrize("use_alibi", [False, True])
def test_lane_gradients_match_pallas(use_alibi):
    window = 4
    arrays = _make(seed=1)
    slopes = _slopes(use_alibi)
    jq, jk, jv, *masks = _jax(arrays)

    def loss(q, k, v):
        out = jla.lane_window_attention(q, k, v, *masks, window=window, slopes=slopes, use_pallas=True)
        return jnp.sum(jnp.sin(out))

    expected = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v, *tmasks = _torch(arrays)
    for t in (q, k, v):
        t.requires_grad_()
    tla.lane_window_attention(q, k, v, *tmasks, window=window, slopes=slopes).sin().sum().backward()
    for got, want in zip((q.grad, k.grad, v.grad), expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rows_without_a_valid_key_are_exactly_zero():
    window = 4
    arrays = _make(invalid_rows=True, seed=2)
    expected = jla.lane_window_attention(*_jax(arrays), window=window, use_pallas=True)
    q, k, v, *masks = _torch(arrays)
    for t in (q, k, v):
        t.requires_grad_()
    out = tla.lane_window_attention(q, k, v, *masks, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), **TOL)
    assert not out[0].any()  # env 0: no valid key anywhere
    assert not out[1, :, window:].any()  # env 1: queries past its cache see nothing
    out.sum().backward()
    assert torch.isfinite(q.grad).all() and not q.grad[0].any()


def test_bf16_inputs_match_pallas():
    """bf16 q/k/v as the transformer feeds them: fp32 out, gradients in the
    inputs' dtype (lane_attention.py:306-321)."""
    window = 4
    arrays = _make(seed=3)
    jq, jk, jv, *masks = _jax(arrays, jnp.bfloat16)

    def loss(q, k, v):
        out = jla.lane_window_attention(q, k, v, *masks, window=window, use_pallas=True)
        return jnp.sum(jnp.sin(out)), out

    expected, out_ref = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    q, k, v, *tmasks = _torch(arrays, torch.bfloat16)
    for t in (q, k, v):
        t.requires_grad_()
    out = tla.lane_window_attention(q, k, v, *tmasks, window=window)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), **TOL)
    out.sin().sum().backward()
    for got, want in zip((q.grad, k.grad, v.grad), expected):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_GRAD_TOL)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """K3b's plain version (the backward the card's kernel is held to) equals
    autograd through K3f's plain version, ALiBi on, ragged T."""
    window = 5
    q, k, v, *masks = _torch(_make(t_len=7, window=window, seed=4))
    for t in (q, k, v):
        t.requires_grad_()
    out, probs = tla.lane_fwd_plain(q, k, v, *masks, window, (0.5, 0.25), save_probs=True)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    expected = torch.autograd.grad(out, (q, k, v), g)
    got = tla.lane_bwd_plain(q.detach(), k.detach(), v.detach(), probs.detach(), g, window)
    for a, b in zip(got, expected):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("t_len,window", [(8, 4), (7, 5)])
def test_next_token_matches_pallas(use_alibi, t_len, window):
    arrays = _make(t_len=t_len, window=window, seed=5, invalid_rows=True)
    rng = np.random.default_rng(6)
    k_self = rng.standard_normal(arrays[0].shape).astype(np.float32)
    v_self = rng.standard_normal(arrays[0].shape).astype(np.float32)
    slopes = _slopes(use_alibi)
    jq, jk, jv, *masks = _jax(arrays)
    expected = jla.lane_next_token_attention(jq, jnp.asarray(k_self), jnp.asarray(v_self), jk, jv, *masks,
                                             window=window, slopes=slopes, use_pallas=True)
    q, k, v, *tmasks = _torch(arrays)
    got = tla.lane_next_token_attention(q, torch.from_numpy(k_self), torch.from_numpy(v_self), k, v, *tmasks,
                                        window=window, slopes=slopes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_primal_and_grad_variants_agree_and_count_no_launches():
    window = 4
    q, k, v, *masks = _torch(_make(seed=7))
    tla.reset_launch_counts()
    with torch.no_grad():
        primal = tla.lane_window_attention(q, k, v, *masks, window=window)
    with_grad = tla.lane_window_attention(q.requires_grad_(), k, v, *masks, window=window)
    assert with_grad.requires_grad and not primal.requires_grad
    torch.testing.assert_close(primal, with_grad.detach(), rtol=0, atol=0)
    with_grad.sum().backward()
    assert tla.LAUNCHES == {"K3f": 0, "K3b": 0, "K6": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    window = 4
    q, k, v, *masks = _torch(_make(seed=8))
    with pytest.raises(TypeError, match="sequence of floats"):
        tla.lane_window_attention(q, k, v, *masks, window=window, slopes=torch.ones(2))
    meta = [t.to("meta") for t in (q, k, v, *masks)]
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tla.lane_window_attention(*meta, window=window)
    probs = torch.zeros(*q.shape[:3], window + 1)
    with pytest.raises(ValueError, match="W\\+T"):
        tla._bwd_params(q, k[:, :, 1:], v[:, :, 1:], probs, q, *masks, window)
    with pytest.raises(ValueError, match="head dims"):
        tla._bwd_params(q[..., :6], k[..., :6], v[..., :6], probs, q[..., :6], *masks, window)
    with pytest.raises(ValueError, match="probs"):
        tla._bwd_params(q, k, v, probs[..., 1:], q, *masks, window)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tla._launch_bwd(q, k, v, probs, q, *masks, window, torch.float16)
