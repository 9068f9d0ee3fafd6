"""The port's fused-MLP kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode.

Inputs and weights are made with numpy from a seed and fed to both.  JAX's
kernels take ``[in, out]`` weights and ``[1, out]`` biases; the port's take
``[out, in]`` and ``[out]``.  Tolerances are those of tests/test_fused_mlp.py:
2e-2 on the bf16 forward (one bf16 ulp at |h| ~ 2 is 1.6e-2; the two sides
accumulate in a different order, which can flip a rounding), atol 3e-3 /
rtol 3e-2 on gradients (bf16 cotangents rounded at each layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.kernels import fused_mlp as jfm
from cusrl_tpu_torch.nn.kernels import fused_mlp as tfm

DIMS = (48, 64, 32)
ROWS = 100  # ragged against block_rows=32
FWD_TOL = dict(atol=2e-2, rtol=2e-2)
GRAD_TOL = dict(atol=3e-3, rtol=3e-2)


def _make(seed, dims=DIMS, rows=ROWS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, dims[0])).astype(np.float32)
    ws = [(rng.standard_normal((dims[i + 1], dims[i])) / np.sqrt(dims[i])).astype(np.float32) for i in range(len(dims) - 1)]
    bs = [(rng.standard_normal(dims[i + 1]) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    tgt = rng.standard_normal((rows, dims[-1])).astype(np.float32)
    return x, ws, bs, tgt


def _jax_params(ws, bs):
    return tuple(jnp.asarray(w.T) for w in ws), tuple(jnp.asarray(b[None, :]) for b in bs)


def _torch_params(ws, bs):
    return [torch.tensor(w, requires_grad=True) for w in ws], [torch.tensor(b, requires_grad=True) for b in bs]


def _f32(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "identity"])
@pytest.mark.parametrize("trailing", [True, False])
def test_forward_matches_pallas(activation, trailing):
    x, ws, bs, _ = _make(0)
    expected = jfm.fused_mlp(jnp.asarray(x), *_jax_params(ws, bs), activation, trailing,
                             use_pallas=True, block_rows=32, interpret=True)
    with torch.no_grad():
        got = tfm.fused_mlp(torch.from_numpy(x), *_torch_params(ws, bs), activation, trailing)
    assert got.dtype == torch.bfloat16 and got.shape == (ROWS, DIMS[-1])
    np.testing.assert_allclose(_f32(got), _f32(expected), **FWD_TOL)


def test_saved_hiddens_match_pallas():
    x, ws, bs, _ = _make(1)
    jw, jb = _jax_params(ws, bs)
    _, hiddens = jfm._run_fwd(jnp.asarray(x), jw, jb, "elu", True, 32, True, save_hiddens=True)
    _, port_hiddens = tfm.mlp_chain_fwd_plain(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                              [torch.from_numpy(b) for b in bs], "elu", True, True)
    assert len(port_hiddens) == len(hiddens) == len(DIMS) - 2
    for got, expected in zip(port_hiddens, hiddens):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(expected)[:ROWS], **FWD_TOL)


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh"])
def test_gradients_match_pallas(activation):
    x, ws, bs, tgt = _make(2)

    def jax_loss(params, x_):
        out = jfm.fused_mlp(x_, *params, activation, True, use_pallas=True, block_rows=32, interpret=True)
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt))

    (g_params, g_x) = jax.grad(jax_loss, argnums=(0, 1))(_jax_params(ws, bs), jnp.asarray(x))

    tw, tb = _torch_params(ws, bs)
    tx = torch.tensor(x, requires_grad=True)
    out = tfm.fused_mlp(tx, tw, tb, activation, True)
    torch.mean((out.float() - torch.from_numpy(tgt)).square()).backward()

    for w, gw in zip(tw, g_params[0]):
        np.testing.assert_allclose(_f32(w.grad), np.asarray(gw).T, **GRAD_TOL)
    for b, gb in zip(tb, g_params[1]):
        np.testing.assert_allclose(_f32(b.grad), np.asarray(gb)[0], **GRAD_TOL)
    np.testing.assert_allclose(_f32(tx.grad), np.asarray(g_x), **GRAD_TOL)


@pytest.mark.parametrize("skip_input_grad", [False, True])
def test_pair_matches_pallas(skip_input_grad):
    xa, wsa, bsa, tgt = _make(3)
    xc, wsc, bsc, _ = _make(4)

    def jax_loss(params, xa_, xc_):
        (wa, ba), (wc, bc) = params
        a, c = jfm.fused_mlp_pair(xa_, xc_, wa, ba, wc, bc, "elu", True, use_pallas=True, block_rows=32,
                                  interpret=True, skip_input_grad=skip_input_grad)
        loss = jnp.mean(jnp.square(a.astype(jnp.float32) - tgt)) + jnp.mean(jnp.square(c.astype(jnp.float32) + tgt))
        return loss, (a, c)

    params = (_jax_params(wsa, bsa), _jax_params(wsc, bsc))
    grads, (ja, jc) = jax.grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(xa), jnp.asarray(xc))

    twa, tba = _torch_params(wsa, bsa)
    twc, tbc = _torch_params(wsc, bsc)
    txa, txc = torch.tensor(xa, requires_grad=True), torch.tensor(xc, requires_grad=True)
    a, c = tfm.fused_mlp_pair(txa, txc, twa, tba, twc, tbc, "elu", True, skip_input_grad=skip_input_grad)
    tt = torch.from_numpy(tgt)
    (torch.mean((a.float() - tt).square()) + torch.mean((c.float() + tt).square())).backward()

    np.testing.assert_allclose(_f32(a), _f32(ja), **FWD_TOL)
    np.testing.assert_allclose(_f32(c), _f32(jc), **FWD_TOL)
    for (tw, tb), (gw, gb) in zip(((twa, tba), (twc, tbc)), grads[0]):
        for w, g in zip(tw, gw):
            np.testing.assert_allclose(_f32(w.grad), np.asarray(g).T, **GRAD_TOL)
        for b, g in zip(tb, gb):
            np.testing.assert_allclose(_f32(b.grad), np.asarray(g)[0], **GRAD_TOL)
    if skip_input_grad:
        assert txa.grad is None and txc.grad is None
        assert not np.any(np.asarray(grads[1])) and not np.any(np.asarray(grads[2]))
    else:
        np.testing.assert_allclose(_f32(txa.grad), np.asarray(grads[1]), **GRAD_TOL)
        np.testing.assert_allclose(_f32(txc.grad), np.asarray(grads[2]), **GRAD_TOL)


def test_backward_plain_matches_pallas_bwd_with_injected_cotangent():
    """mlp_chain_bwd_plain against _run_bwd on the same saved activations and
    the same bf16 cotangent, with and without layer 0's dX."""
    x, ws, bs, _ = _make(5)
    g = np.random.default_rng(6).standard_normal((ROWS, DIMS[-1])).astype(np.float32)
    jw, jb = _jax_params(ws, bs)
    jx, jg = jnp.asarray(x), jnp.asarray(g).astype(jnp.bfloat16)
    out, hiddens = jfm._run_fwd(jx, jw, jb, "tanh", True, 32, True, save_hiddens=True)
    dx, dws, dbs = jfm._run_bwd(jx, jg, jw, hiddens, out, "tanh", True, 32, True)

    tx = torch.from_numpy(x)
    tw = [torch.from_numpy(w) for w in ws]
    tout, th = tfm.mlp_chain_fwd_plain(tx, tw, [torch.from_numpy(b) for b in bs], "tanh", True, True)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    for skip in (False, True):
        pdx, pdws, pdbs = tfm.mlp_chain_bwd_plain(tx, tg, tw, [*th, tout], "tanh", True, skip)
        for a, b in zip(pdws, dws):
            np.testing.assert_allclose(_f32(a), np.asarray(b).T, **GRAD_TOL)
        for a, b in zip(pdbs, dbs):
            np.testing.assert_allclose(_f32(a), np.asarray(b)[0], **GRAD_TOL)
        if skip:
            assert pdx is None
        else:
            np.testing.assert_allclose(_f32(pdx), np.asarray(dx), **GRAD_TOL)


FFN_DIMS = (32, 64, 32)  # the transformer FFN's shape, narrowed: up, gelu, down


def test_gelu_chain_matches_pallas():
    """The FFN chain (gelu between two layers, none after): output, saved
    pre-activations, and the gradients of the inputs and the parameters."""
    x, ws, bs, tgt = _make(8, dims=FFN_DIMS)
    jw, jb = _jax_params(ws, bs)
    expected = jfm.fused_mlp(jnp.asarray(x), jw, jb, "gelu", False, use_pallas=True, block_rows=32,
                             interpret=True)
    _, j_saved = jfm._run_fwd(jnp.asarray(x), jw, jb, "gelu", False, 32, True, save_hiddens=True)
    t_out, t_saved = tfm.mlp_chain_fwd_plain(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                             [torch.from_numpy(b) for b in bs], "gelu", False, True)
    np.testing.assert_allclose(_f32(t_out), _f32(expected), **FWD_TOL)
    assert len(t_saved) == len(j_saved) == 1
    np.testing.assert_allclose(_f32(t_saved[0]), _f32(j_saved[0])[:ROWS], **FWD_TOL)

    def jax_loss(params, x_):
        out = jfm.fused_mlp(x_, *params, "gelu", False, use_pallas=True, block_rows=32, interpret=True)
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt))

    g_params, g_x = jax.grad(jax_loss, argnums=(0, 1))((jw, jb), jnp.asarray(x))
    tw, tb = _torch_params(ws, bs)
    tx = torch.tensor(x, requires_grad=True)
    out = tfm.fused_mlp(tx, tw, tb, "gelu", False)
    torch.mean((out.float() - torch.from_numpy(tgt)).square()).backward()
    for w, gw in zip(tw, g_params[0]):
        np.testing.assert_allclose(_f32(w.grad), np.asarray(gw).T, **GRAD_TOL)
    for b, gb in zip(tb, g_params[1]):
        np.testing.assert_allclose(_f32(b.grad), np.asarray(gb)[0], **GRAD_TOL)
    np.testing.assert_allclose(_f32(tx.grad), np.asarray(g_x), **GRAD_TOL)


def test_gelu_backward_plain_matches_pallas_bwd():
    """mlp_chain_bwd_plain from the saved pre-activations against _run_bwd
    on the same bf16 cotangent: gelu' from z, h = bf16(gelu(z)) recomputed
    for the second layer's dW."""
    x, ws, bs, _ = _make(9, dims=FFN_DIMS)
    g = np.random.default_rng(10).standard_normal((ROWS, FFN_DIMS[-1])).astype(np.float32)
    jw, jb = _jax_params(ws, bs)
    jx, jg = jnp.asarray(x), jnp.asarray(g).astype(jnp.bfloat16)
    out, saved = jfm._run_fwd(jx, jw, jb, "gelu", False, 32, True, save_hiddens=True)
    dx, dws, dbs = jfm._run_bwd(jx, jg, jw, saved, out, "gelu", False, 32, True)
    tx, tw = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    tout, tsaved = tfm.mlp_chain_fwd_plain(tx, tw, [torch.from_numpy(b) for b in bs], "gelu", False, True)
    pdx, pdws, pdbs = tfm.mlp_chain_bwd_plain(tx, torch.from_numpy(g).to(torch.bfloat16), tw, [*tsaved, tout],
                                              "gelu", False, False)
    for a, b in zip(pdws, dws):
        np.testing.assert_allclose(_f32(a), np.asarray(b).T, **GRAD_TOL)
    for a, b in zip(pdbs, dbs):
        np.testing.assert_allclose(_f32(a), np.asarray(b)[0], **GRAD_TOL)
    np.testing.assert_allclose(_f32(pdx), np.asarray(dx), **GRAD_TOL)


def test_plain_versions_count_no_launches():
    x, ws, bs, _ = _make(7)
    tfm.reset_launch_counts()
    tw, tb = _torch_params(ws, bs)
    out = tfm.fused_mlp(torch.from_numpy(x), tw, tb)
    out.float().sum().backward()
    tfm.fused_mlp_pair(torch.from_numpy(x), torch.from_numpy(x), tw, tb, tw, tb)
    assert tfm.LAUNCHES == {"K1f": 0, "K1b": 0, "K2f": 0, "K2b": 0, "K8f": 0, "K8b": 0, "K9s": 0, "K9m": 0}


def test_supported_activations_and_widths():
    assert all(tfm.supports_fused_mlp(a, 3) for a in ("elu", "relu", "tanh", "gelu", "identity"))
    assert not tfm.supports_fused_mlp("gelu", 3, trailing=True)  # its output slot holds the primal
    assert not tfm.supports_fused_mlp("swish", 3)
    assert not tfm.supports_fused_mlp("elu", tfm.MAX_LAYERS + 1)
    x = torch.zeros(8, 48)
    tfm._validate([x], [[torch.zeros(512, 48), torch.zeros(128, 512)]], [[torch.zeros(512), torch.zeros(128)]])
    with pytest.raises(ValueError, match="multiples of 16"):
        tfm._validate([x], [[torch.zeros(100, 48)]], [[torch.zeros(100)]])
    with pytest.raises(ValueError, match="up to 512"):
        tfm._validate([x], [[torch.zeros(1024, 48)]], [[torch.zeros(1024)]])


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    x = torch.zeros(8, 16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tfm.fused_mlp(x, [torch.zeros(16, 16, device="meta")], [torch.zeros(16, device="meta")])


@pytest.mark.parametrize("width", [1, 2, 3, 4, 6, 8, 24, 48])
def test_narrow_inputs_pad_to_the_kernels_k_step(width):
    """An input width that is not a multiple of 16 reaches the kernels as x
    and W_0 with zero columns up to the next one; the zero terms leave the
    plain chain's outputs and gradients as they were, and the backward's
    launch hands back dW_0 and dX without the padding's columns."""
    gen = torch.Generator().manual_seed(width)
    dims = (width, 64, 64)
    ws = [torch.randn(b, a, generator=gen) / a ** 0.5 for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn(b, generator=gen) * 0.1 for b in dims[1:]]
    x = torch.randn(100, width, generator=gen)
    (xp,), (wp,) = tfm.pad_input([x], [ws])
    padded = -(-width // 16) * 16
    assert xp.shape == (100, padded) and wp[0].shape == (64, padded) and wp[1] is ws[1]
    if padded == width:
        assert xp is x and wp[0] is ws[0]
    assert not xp[:, width:].any() and not wp[0][:, width:].any()
    assert tfm._validate([x], [ws], [bs]) == list(dims)
    out, hid = tfm.mlp_chain_fwd_plain(x, ws, bs, "tanh", True, True)
    out_p, hid_p = tfm.mlp_chain_fwd_plain(xp, wp, bs, "tanh", True, True)
    torch.testing.assert_close(out_p, out, rtol=0, atol=0)
    g = (torch.randn(100, 64, generator=gen) * 0.01).to(torch.bfloat16)
    dx, dws, dbs = tfm.mlp_chain_bwd_plain(x, g, ws, [*hid, out], "tanh", True, False)
    dx_p, dws_p, dbs_p = tfm.mlp_chain_bwd_plain(xp, g, wp, [*hid, out], "tanh", True, False)
    torch.testing.assert_close(dx_p[:, :width], dx, rtol=0, atol=1e-6)
    torch.testing.assert_close(dws_p[0][:, :width], dws[0], rtol=0, atol=1e-6)
    assert not dws_p[0][:, width:].any() and not dx_p[:, width:].any()
    for skip in (False, True):
        p, _, results, _ = tfm._bwd_params([x], [g], [ws], [[*hid, out]], "tanh", True, skip, None, None)
        rdx, rdws, _, _ = results[0]
        assert list(p.dims[:3]) == [padded, 64, 64]
        assert rdws[0].shape == (64, width) and rdws[1].shape == (64, 64)
        assert rdx is None if skip else rdx.shape == (100, width)


def test_input_width_limits():
    x = torch.zeros(8, 520)
    with pytest.raises(ValueError, match="input width up to 512"):
        tfm._validate([x], [[torch.zeros(64, 520)]], [[torch.zeros(64)]])
    with pytest.raises(ValueError, match="multiples of 16"):
        tfm._validate([torch.zeros(8, 4)], [[torch.zeros(40, 4)]], [[torch.zeros(40)]])
