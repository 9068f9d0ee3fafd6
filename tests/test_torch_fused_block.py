"""The port's fused transformer block (``nn/kernels/fused_block.py``, K4/K5)
and the encoder layer's fused route, against the JAX package on the CPU.

Kernel level: the port's plain versions (what its wrappers run on CPU
tensors) against the Pallas kernels in interpret mode
(``cusrl_tpu/nn/kernels/fused_block.py``), the backwards fed the same saved
tensors on both sides.  Inputs come from numpy with a seed.

Tolerances, with their reasons:
- ``EXACT_FP32`` (rtol/atol 1e-4 on values of order 1-10): the backwards and
  the pre forward repeat the kernels' arithmetic; only fp32 summation order
  (and, for gelu, the tanh) differs.
- ``BF16`` (2e-2): bf16 outputs one rounding apart.  The post forward needs
  it: in interpret mode on the CPU, XLA drops the bf16 rounding of the
  residual ``r1`` before LN2 (the convert pair is simplified away), while the
  kernel as written (and the port) rounds it, so about half of the FFN's bf16
  pre-activations sit one rounding apart.
- Layer level (the port under ``force`` against the JAX layer under
  ``force``, and the port's fused route against its modular route): the
  JAX package's own fused-against-modular tolerances
  (``tests/test_fused_block.py``): outputs and memories 5e-2, gradients
  atol 2e-2 / rtol 8e-2, for bf16 roundings that fall differently and carry
  through LayerNorm and the FFN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.kernels import fused_block as jfb
from cusrl_tpu.nn.module import causal_attn as jca
from cusrl_tpu_torch.nn.kernels import fused_block as tfb
from cusrl_tpu_torch.nn.module import causal_attn as tca

EXACT_FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
LAYER_OUT = dict(rtol=5e-2, atol=5e-2)
LAYER_GRAD = dict(rtol=8e-2, atol=2e-2)
IN_DIM, EMBED, FF = 12, 16, 64


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(_np(a))).to(dtype)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _params(seed):
    """Port-layout pre and post parameters (``[out, in]`` weights) as numpy."""
    rng = np.random.default_rng(seed)

    def w(out, inp):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(np.float32)

    def v(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    e, f = EMBED, FF
    pre = [w(e, IN_DIM), v(e), v(e, 1.0), v(e), w(e, e), w(e, e), w(e, e), v(e), v(e), v(e)]
    post = [w(e, e), v(e), v(e, 1.0), v(e), w(f, e), v(f), w(e, f), v(e)]
    return pre, post


def _jax_pre(pre):
    """JAX layout: ``(w_in^T, b_in, g1, bb1, w_qkv, b_qkv)`` with [1, dim] rows."""
    w_in, b_in, g1, bb1, wq, wk, wv, bq, bk, bv = (jnp.asarray(a) for a in pre)
    return (w_in.T, b_in[None], g1[None], bb1[None], jnp.concatenate([wq.T, wk.T, wv.T], 1),
            jnp.concatenate([bq, bk, bv])[None])


def _jax_post(post):
    w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down = (jnp.asarray(a) for a in post)
    return w_o.T, b_o[None], g2[None], bb2[None], w_up.T, b_up[None], w_down.T, b_down[None]


# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [64, 100])
@pytest.mark.parametrize("skip_input_grad", [True, False])
def test_pre_matches_jax_pallas(rows, skip_input_grad):
    """Forward and hand-written backward against ``_pre_run_fwd`` /
    ``_pre_run_bwd`` (64-row tiles, so 100 rows are ragged), with an fp32
    residual cotangent, as the composed block hands it over."""
    pre, _ = _params(1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((rows, IN_DIM)).astype(np.float32)
    gh = (0.1 * rng.standard_normal((rows, EMBED))).astype(np.float32)
    gqkv = jnp.asarray(0.1 * rng.standard_normal((rows, 3 * EMBED)), jnp.bfloat16)
    jp = _jax_pre(pre)
    jh, jqkv = jfb._pre_run_fwd(jnp.asarray(x), *jp, 64, True)
    h, qkv = tfb.pre_fwd_plain(_t(x), *(_t(a) for a in pre))
    assert h.dtype == torch.float32 and qkv.dtype == torch.bfloat16
    _close(h, jh, EXACT_FP32)
    _close(qkv, jqkv, BF16)
    want = jfb._pre_run_bwd(jnp.asarray(x), jh, jnp.asarray(gh), gqkv, jp[0], jp[4], jp[2], jp[3], 64, True,
                            skip_input_grad)
    got = tfb.pre_bwd_plain(_t(x), _t(jh), _t(gh), _t(gqkv, torch.bfloat16), _t(pre[0]), *(_t(a) for a in pre[4:7]),
                            _t(pre[2]), _t(pre[3]), skip_input_grad)
    dx, dw_in, db_in, dg1, dbb1, dw_qkv, db_qkv = want
    assert (got[0] is None) == skip_input_grad
    if not skip_input_grad:
        _close(got[0], dx, EXACT_FP32, "dx")
    for name, a, b in zip(("dw_in", "db_in", "dg1", "dbb1"), got[1:5], (_np(dw_in).T, db_in[0], dg1[0], dbb1[0])):
        _close(a, b, EXACT_FP32, name)
    _close(torch.cat(got[5:8]), _np(dw_qkv).T, EXACT_FP32, "dw_qkv")
    _close(torch.cat(got[8:11]), db_qkv[0], EXACT_FP32, "db_qkv")


@pytest.mark.parametrize("activation", ["gelu", "elu", "relu", "tanh", "identity"])
@pytest.mark.parametrize("rows", [64, 100])
def test_post_matches_jax_pallas(activation, rows):
    """Forward (saving r1 and the FFN activations) and hand-written backward
    against ``_post_run_fwd`` / ``_post_run_bwd``; the backward from JAX's
    saved tensors on both sides."""
    pre, post = _params(3)
    rng = np.random.default_rng(4)
    attn = rng.standard_normal((rows, EMBED)).astype(np.float32)
    h = jnp.asarray(rng.standard_normal((rows, EMBED)), jnp.bfloat16)
    g = jnp.asarray(0.1 * rng.standard_normal((rows, EMBED)), jnp.bfloat16)
    jp = _jax_post(post)
    # The saved tensors come back padded to the tile; the backward takes them so.
    jout, jr1_pad, js_pad = jfb._post_run_fwd(jnp.asarray(attn), h, *jp, activation, 64, True, True)
    jr1, js = jr1_pad[:rows], js_pad[:rows]
    out, r1, saved = tfb.post_fwd_plain(_t(attn), _t(h), *(_t(a) for a in post), activation, True)
    _close(out, jout, BF16)
    _close(r1, jr1, dict(rtol=0, atol=0))
    _close(saved, js, BF16)
    want = jfb._post_run_bwd(jnp.asarray(attn), g, jr1_pad, js_pad, jp[0], jp[4], jp[6], jp[2], jp[3], activation,
                             64, True)
    got = tfb.post_bwd_plain(_t(attn), _t(g, torch.bfloat16), _t(jr1, torch.bfloat16), _t(js, torch.bfloat16),
                             *(_t(post[i]) for i in (0, 4, 6, 2, 3)), activation)
    names = ("dattn", "dh", "dw_o", "db_o", "dg2", "dbb2", "dw_up", "db_up", "dw_down", "db_down")
    for name, a, b in zip(names, got, want):
        b = _np(b)
        _close(a, b.T if name.startswith("dw") else (b[0] if name[1] in "bg" and b.shape[0] == 1 else b),
               EXACT_FP32, name)


def test_pair_ops_match_jax_pallas_pair():
    """The port's pair ops under autograd (two chains: K5's plain versions)
    against ``fused_block_pair_pre`` / ``fused_block_pair_post`` with
    ``use_pallas=True, interpret=True``: outputs and every gradient."""
    rows = 100
    (pre_a, post_a), (pre_c, post_c) = _params(5), _params(6)
    rng = np.random.default_rng(7)
    xa, xc = (rng.standard_normal((rows, IN_DIM)).astype(np.float32) for _ in range(2))
    noise = [rng.standard_normal((rows, EMBED)).astype(np.float32) for _ in range(2)]
    tgt = [rng.standard_normal((rows, EMBED)).astype(np.float32) for _ in range(2)]

    def jloss(pa, pc, qa, qc):
        ha, hc, qkva, qkvc = jfb.fused_block_pair_pre(jnp.asarray(xa), jnp.asarray(xc), pa, pc, use_pallas=True,
                                                      interpret=True)
        attna = qkva[:, :EMBED].astype(jnp.float32) * noise[0]
        attnc = qkvc[:, :EMBED].astype(jnp.float32) * noise[1]
        outa, outc = jfb.fused_block_pair_post(attna, attnc, ha, hc, qa, qc, "gelu", use_pallas=True, interpret=True)
        return jnp.sum(outa.astype(jnp.float32) * tgt[0]) + jnp.sum(outc.astype(jnp.float32) * tgt[1]), (outa, outc)

    jargs = (_jax_pre(pre_a), _jax_pre(pre_c), _jax_post(post_a), _jax_post(post_c))
    (_, (jouta, joutc)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)

    leaves = [[_t(a).requires_grad_() for a in p] for p in (pre_a, pre_c, post_a, post_c)]
    ha, hc, qkva, qkvc = tfb.fused_block_pair_pre(_t(xa), _t(xc), leaves[0], leaves[1])
    attna = qkva[:, :EMBED].float() * _t(noise[0])
    attnc = qkvc[:, :EMBED].float() * _t(noise[1])
    outa, outc = tfb.fused_block_pair_post(attna, attnc, ha, hc, leaves[2], leaves[3], "gelu")
    ((outa.float() * _t(tgt[0])).sum() + (outc.float() * _t(tgt[1])).sum()).backward()
    _close(outa, jouta, BF16)
    _close(outc, joutc, BF16)
    for which, (ports, jgrad) in enumerate(zip(leaves, jgrads)):
        jg = [_np(a) for a in jgrad]
        if which < 2:  # pre: w_in^T, b_in, g1, bb1, w_qkv, b_qkv
            want = [jg[0].T, jg[1][0], jg[2][0], jg[3][0], *np.split(jg[4].T, 3), *np.split(jg[5][0], 3)]
        else:
            want = [a.T if a.shape[0] > 1 else a[0] for a in jg]
        for i, (p, b) in enumerate(zip(ports, want)):
            scale = max(np.abs(b).max(), 1.0)
            np.testing.assert_allclose(_np(p.grad) / scale, b / scale, atol=2e-2, err_msg=f"{which}.{i}")


def test_residual_cotangent_reaches_pre_in_fp32(monkeypatch):
    """pre -> post under autograd: the residual's cotangent reaches the pre
    backward in fp32, as JAX's Pallas route hands it to ``_pre_run_bwd``
    (PyTorch would round it to a bf16 h's dtype).  Rounding it to bf16
    instead moves the input projection's gradients measurably."""
    rows = 256
    pre, post = _params(8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((rows, IN_DIM)).astype(np.float32)
    noise = rng.standard_normal((rows, EMBED)).astype(np.float32)
    tgt = rng.standard_normal((rows, EMBED)).astype(np.float32)

    seen_jax = []
    run_bwd = jfb._pre_run_bwd

    def recording(x_, h_, gh, *rest):
        seen_jax.append(gh.dtype)
        return run_bwd(x_, h_, gh, *rest)

    monkeypatch.setattr(jfb, "_pre_run_bwd", recording)

    def jloss(p):
        h, qkv = jfb.fused_block_pre(jnp.asarray(x), *p, use_pallas=True, interpret=True)
        out = jfb.fused_block_post(qkv[:, :EMBED].astype(jnp.float32) * noise, h, *_jax_post(post), "gelu",
                                   use_pallas=True, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * tgt)

    jgrads = [_np(a) for a in jax.grad(jloss)(_jax_pre(pre))]
    assert seen_jax == [jnp.float32]
    want = [jgrads[0].T, jgrads[1][0], jgrads[2][0], jgrads[3][0]]

    def port_grads(round_gh: bool):
        leaves = [_t(a).requires_grad_() for a in pre]
        h, qkv = tfb.fused_block_pre(_t(x), *leaves)
        seen = []
        h.register_hook(lambda g: seen.append(g) or (g.to(torch.bfloat16).float() if round_gh else g))
        out = tfb.fused_block_post(qkv[:, :EMBED].float() * _t(noise), h, *(_t(a) for a in post), "gelu")
        (out.float() * _t(tgt)).sum().backward()
        return [p.grad for p in leaves[:4]], seen[0]

    grads, gh = port_grads(False)
    assert gh.dtype == torch.float32 and not torch.equal(gh, gh.to(torch.bfloat16).float())
    rounded, _ = port_grads(True)

    def rel(a, b):
        return np.abs(_np(a) - b).max() / np.abs(b).max()

    # Against JAX the forwards' interpret-mode r1 difference dominates
    # (measured 1.4e-3 to 4.9e-3 of the largest element).
    for name, g, w in zip(("dw_in", "db_in", "dg1", "dbb1"), grads, want):
        assert rel(g, w) < 1e-2, name
    # Rounding the cotangent to bf16 moves the input projection's gradients
    # by 1.8e-3 (dW_in) and 6.9e-4 (db_in) of their largest element here.
    assert rel(rounded[0], _np(grads[0])) > 5e-4 and rel(rounded[1], _np(grads[1])) > 2e-4


def test_primal_post_equals_saving_forward():
    """The primal op (no grad: saves nothing) gives the saving forward's
    output bit for bit (``tests/test_fused_block.py:119-129``)."""
    _, post = _params(10)
    rng = np.random.default_rng(11)
    attn = _t(rng.standard_normal((100, EMBED)))
    h = _t(rng.standard_normal((100, EMBED))).to(torch.bfloat16).float()
    leaves = [_t(a).requires_grad_() for a in post]
    with torch.no_grad():
        primal = tfb.fused_block_post(attn, h, *leaves, "gelu")
    saving = tfb.fused_block_post(attn, h, *leaves, "gelu")
    assert saving.requires_grad and not primal.requires_grad
    torch.testing.assert_close(primal, saving.detach(), rtol=0, atol=0)


def test_unsupported_activation_takes_the_reference():
    """An activation the kernels do not take runs the reference, as
    ``fused_block.py:605-606``, and stays differentiable.  The port's
    reference applies the named activation; JAX's ``_post_reference`` passes
    names outside ``fused_mlp._act``'s four through as the identity (no
    route reaches either: the layer's eligibility asks for a supported one),
    so the expected value is built from JAX's reference pieces here."""
    _, post = _params(12)
    rng = np.random.default_rng(13)
    attn = _t(rng.standard_normal((20, EMBED)))
    h = _t(rng.standard_normal((20, EMBED))).to(torch.bfloat16).float()
    assert not tfb.supports_fused_block("silu") and tfb.supports_fused_block("GELU")
    leaves = [_t(a).requires_grad_() for a in post]
    out = tfb.fused_block_post(attn, h, *leaves, "silu")
    w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down = _jax_post(post)
    r1 = jnp.asarray(_np(h), jnp.bfloat16) + jfb._linear_ref(jnp.asarray(_np(attn)), w_o, b_o)
    hid = jax.nn.silu(jfb._linear_ref(jfb._ln_ref(r1, g2, bb2), w_up, b_up))
    _close(out, r1 + jfb._linear_ref(hid, w_down, b_down), BF16)
    out.float().sum().backward()
    assert all(p.grad is not None for p in leaves)


# ---------------------------------------------------------------------------
# Layer level: the fused route
# ---------------------------------------------------------------------------


def _layer_pair(seed=0, **kwargs):
    kwargs = dict(dict(embed_dim=32, num_heads=2, window=4, ff_dim=64, compute_dtype="bfloat16"), **kwargs)
    j = jca.CausalTransformerEncoderLayerFactory(**kwargs)(IN_DIM, None, jax.random.key(seed))
    t = tca.CausalTransformerEncoderLayerFactory(**kwargs)(IN_DIM, None)
    given = {path: np.asarray(leaf) for path, leaf in tree_paths(j)}
    params = dict(t.named_parameters())
    assert set(params) == set(given)
    with torch.no_grad():
        for path, param in params.items():
            param.copy_(torch.from_numpy(np.array(given[path], np.float32)))
    return j, t


def _memories(j, batch, seed, cursor=3):
    """A part-valid ring at cursor 3, as JAX and port memories."""
    rng = np.random.default_rng(seed)
    mem = j.init_memory(batch)
    mem = {
        "k_cache": jnp.asarray(rng.standard_normal(mem["k_cache"].shape), jnp.bfloat16),
        "v_cache": jnp.asarray(rng.standard_normal(mem["v_cache"].shape), jnp.bfloat16),
        "cache_mask": jnp.asarray(rng.random(mem["cache_mask"].shape) < 0.6, jnp.float32),
        "cursor": jnp.asarray(cursor, jnp.int32),
    }
    port = {k: _t(v, torch.bfloat16) for k, v in mem.items() if k.endswith("cache")}
    port["cache_mask"] = _t(mem["cache_mask"])
    port["cursor"] = torch.tensor(cursor)
    return mem, port


def _inputs(t_len, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t_len, batch, IN_DIM)).astype(np.float32),
            rng.random((t_len, batch, 1)) < 0.2)


def _close_memory(got, want, tol):
    for key in ("k_cache", "v_cache", "cache_mask", "cursor"):
        _close(got[key], want[key], tol, key)


def test_layer_eligibility_follows_the_jax_list(monkeypatch):
    x = torch.zeros(8, 12, IN_DIM)
    _, layer = _layer_pair()
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "1")
    assert not layer._fused_eligible(x, True)  # CPU tensors keep the modular route
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    assert layer._fused_eligible(x, True) and layer._fused_eligible(x[0], False)
    assert not layer._fused_eligible(x[0], True) and not layer._fused_eligible(x, False)
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "0")
    assert not layer._fused_eligible(x, True)
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    for kwargs in (dict(norm_mode="post"), dict(gate="gru"), dict(compute_dtype=None)):
        _, other = _layer_pair(**{"compute_dtype": "bfloat16", **kwargs})
        assert not other._fused_eligible(x, True), kwargs
    layer.attention.sequence_mode = "batched"
    assert not layer._fused_eligible(x, True)


def test_layer_fused_sequence_matches_jax(monkeypatch):
    """Sequence mode under ``force`` on both sides: outputs, the final ring
    and every parameter's gradient."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    j, t = _layer_pair(seed=1)
    t_len, batch = 8, 9
    x, done = _inputs(t_len, batch, 20)
    jmem, tmem = _memories(j, batch, 21)
    tgt = np.random.default_rng(22).standard_normal((t_len, batch, 32)).astype(np.float32)

    def jloss(layer):
        out, mem, _ = layer(jnp.asarray(x), jmem, sequential=True, done=jnp.asarray(done))
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt)), (out, mem)

    (_, (jout, jm)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(j)
    assert t._fused_eligible(_t(x), True)
    out, tm, _ = t(_t(x), tmem, sequential=True, done=torch.from_numpy(done))
    _close(out, jout, LAYER_OUT)
    _close_memory(tm, jm, LAYER_OUT)
    ((out.float() - _t(tgt)).square().mean()).backward()
    given = dict(tree_paths(jgrads))
    for path, param in t.named_parameters():
        _close(param.grad, given[path], LAYER_GRAD, path)


def test_layer_fused_next_token_matches_jax(monkeypatch):
    """``sequential_with_ctx`` and ``eval_next_token`` on the fused route
    (K4 around the lane attention and around K6) against JAX under ``force``."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    j, t = _layer_pair(seed=2)
    t_len, batch = 6, 7
    x, done = _inputs(t_len, batch, 30)
    y = np.random.default_rng(31).standard_normal((t_len, batch, IN_DIM)).astype(np.float32)
    jmem, tmem = _memories(j, batch, 32)
    jout, jm, jctx = jax.jit(type(j).sequential_with_ctx)(j, jnp.asarray(x), jmem, jnp.asarray(done))
    jnext = jax.jit(type(j).eval_next_token)(j, jnp.asarray(y), jctx)
    with torch.no_grad():
        out, tm, ctx = t.sequential_with_ctx(_t(x), tmem, torch.from_numpy(done))
        nxt = t.eval_next_token(_t(y), ctx)
    _close(out, jout, LAYER_OUT)
    _close_memory(tm, jm, LAYER_OUT)
    _close(nxt, jnext, LAYER_OUT)


def test_layer_fused_step_matches_jax(monkeypatch):
    """The single-step route (``force``): pre op, ring write and masked SDPA
    (``step_core``), post op, over a few steps, with the ring."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    j, t = _layer_pair(seed=3)
    batch = 9
    jmem, tmem = _memories(j, batch, 40)
    xs = np.random.default_rng(41).standard_normal((6, batch, IN_DIM)).astype(np.float32)
    assert t._fused_eligible(_t(xs[0]), False)
    jstep = jax.jit(lambda layer, x, mem: layer(x, mem)[:2])
    with torch.no_grad():
        for step in range(6):
            jout, jmem = jstep(j, jnp.asarray(xs[step]), jmem)
            out, tmem, _ = t(_t(xs[step]), tmem)
            _close(out, jout, LAYER_OUT, f"step {step}")
    _close_memory(tmem, jmem, LAYER_OUT)


@pytest.mark.parametrize("t_len,batch", [(12, 9), (8, 16)])
def test_layer_fused_route_matches_modular_route(monkeypatch, t_len, batch):
    """The port's own two routes on the same inputs
    (``tests/test_fused_block.py:146-202``): outputs, memory, gradients."""
    j, t = _layer_pair(seed=4)
    x, done = _inputs(t_len, batch, 50)
    _, mem = _memories(j, batch, 51)
    tgt = _t(np.random.default_rng(52).standard_normal((t_len, batch, 32)))
    results = {}
    for mode in ("0", "force"):
        monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", mode)
        t.zero_grad()
        out, new_mem, _ = t(_t(x), mem, sequential=True, done=torch.from_numpy(done))
        (out.float() - tgt).square().mean().backward()
        results[mode] = (out, new_mem, {n: p.grad.clone() for n, p in t.named_parameters()})
    (out_m, mem_m, grads_m), (out_f, mem_f, grads_f) = results["0"], results["force"]
    _close(out_f, out_m, LAYER_OUT)
    _close_memory(mem_f, mem_m, LAYER_OUT)
    for name in grads_m:
        _close(grads_f[name], grads_m[name], LAYER_GRAD, name)


def test_layer_fused_step_consistent_with_fused_sequence(monkeypatch):
    """Stepwise fused rollout equals fused sequence mode on the same inputs
    (``tests/test_fused_block.py:258-277``)."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    _, t = _layer_pair(seed=5)
    t_len, n = 10, 6
    x = _t(np.random.default_rng(60).standard_normal((t_len, n, IN_DIM)))
    memory = t.init_memory(n)
    with torch.no_grad():
        mem, outs = memory, []
        for s in range(t_len):
            out, mem, _ = t(x[s], mem)
            outs.append(out)
        seq, _, _ = t(x, memory, sequential=True, done=torch.zeros(t_len, n, 1, dtype=torch.bool))
    _close(seq, torch.stack(outs), dict(rtol=6e-2, atol=6e-2))


def test_fused_pair_sequence_matches_two_fused_passes(monkeypatch):
    """The pair pass (K5's plain versions) equals the two layers' own fused
    passes, outputs and memories; with ``CUSRL_TPU_PAIR_CONCAT=1`` too, and
    then it matches JAX's concatenated branch (its Pallas kernels in
    interpret mode)."""
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    (ja, ta), (jc, tc) = _layer_pair(seed=6), _layer_pair(seed=7)
    t_len, batch = 8, 5
    xa, done = _inputs(t_len, batch, 70)
    xc, _ = _inputs(t_len, batch, 71)
    _, mem_a = _memories(ja, batch, 72)
    _, mem_c = _memories(jc, batch, 73)
    done = torch.from_numpy(done)
    with torch.no_grad():
        la, lc, ma, mc = tca.fused_pair_sequence(ta, tc, _t(xa), _t(xc), mem_a, mem_c, done)
        ra, rma, _ = ta(_t(xa), mem_a, sequential=True, done=done)
        rc, rmc, _ = tc(_t(xc), mem_c, sequential=True, done=done)
    for got, want in ((la, ra), (lc, rc), (ma, rma), (mc, rmc)):
        if isinstance(got, dict):
            _close_memory(got, want, dict(rtol=0, atol=0))
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    # The one-lane-call pass (both layers' environments in one attention
    # call): the same bits as the two calls, and JAX's concatenated branch.
    monkeypatch.setenv("CUSRL_TPU_PAIR_CONCAT", "1")
    with torch.no_grad():
        concat = tca.fused_pair_sequence(ta, tc, _t(xa), _t(xc), mem_a, mem_c, done)
    for got, want in zip(concat, (la, lc, ma, mc)):
        if isinstance(got, dict):
            _close_memory(got, want, dict(rtol=0, atol=0))
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    jmem_a, jmem_c = _memories(ja, batch, 72)[0], _memories(jc, batch, 73)[0]
    # A fresh function, so no trace made with the variable unset is reused.
    jouts = jax.jit(lambda *args: jca.fused_pair_sequence(*args))(ja, jc, jnp.asarray(xa), jnp.asarray(xc), jmem_a,
                                                                  jmem_c, jnp.asarray(done.numpy()))
    for got, want in zip(concat, jouts):
        if isinstance(got, dict):
            _close_memory(got, want, LAYER_OUT)
        else:
            _close(got, want, LAYER_OUT)
