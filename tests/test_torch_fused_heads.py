"""The port's head-fused pair kernel (K8) and fused PPO step (K9, split mode
and mono mode), their plain versions on the CPU, against the JAX package's
Pallas kernels in interpret mode.

Inputs are made with numpy from a seed.  JAX's kernels take ``[in, out]``
weights and ``[1, out]`` biases; the port's take ``[out, in]`` and ``[out]``.
Tolerances are the JAX package's own tests': tests/test_fused_mlp.py:206-296
(outputs 2e-2, gradients atol 5e-3 / rtol 3e-2) and
tests/test_fused_ppo_step.py:83-95 (loss 1e-3, metrics 2e-3, gradients atol
5e-3 / rtol 3e-2): bf16 chains whose roundings can fall on the other side of a
boundary, fp32 heads and loss.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.kernels import fused_mlp as jfm
from cusrl_tpu.nn.kernels import fused_ppo_step as jfp
from cusrl_tpu_torch.nn.kernels import fused_mlp as tfm
from cusrl_tpu_torch.nn.kernels import fused_ppo_step as tfp

DIMS = (48, 64, 32)
OUT_TOL = dict(atol=2e-2, rtol=2e-2)
GRAD_TOL = dict(atol=5e-3, rtol=3e-2)


def _chain(rng, dims=DIMS):
    ws = [(rng.standard_normal((dims[i + 1], dims[i])) / np.sqrt(dims[i])).astype(np.float32)
          for i in range(len(dims) - 1)]
    bs = [(rng.standard_normal(dims[i + 1]) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    return ws, bs


def _head(rng, out_dim, latent=DIMS[-1]):
    return ((rng.standard_normal((out_dim, latent)) * 0.2).astype(np.float32),
            (rng.standard_normal(out_dim) * 0.1).astype(np.float32))


def _jax(ws, bs):
    return tuple(jnp.asarray(w.T) for w in ws), tuple(jnp.asarray(b[None, :]) for b in bs)


def _torch(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _f32(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("value_dim", [1, 3])
@pytest.mark.parametrize("expose_latent", [False, True])
def test_pair_heads_matches_pallas(value_dim, expose_latent):
    """Outputs and every gradient (chains, heads), 100 rows ragged against
    32-row tiles; with the exposed latent its cotangent flows back too."""
    rng = np.random.default_rng(10 + value_dim)
    wa, ba = _chain(rng)
    wc, bc = _chain(rng)
    wm, bm = _head(rng, 6)
    wv, bv = _head(rng, value_dim)
    xa = rng.standard_normal((100, DIMS[0])).astype(np.float32)
    xc = rng.standard_normal((100, DIMS[0])).astype(np.float32)
    adv = rng.standard_normal((100, 6)).astype(np.float32)
    vtgt = rng.standard_normal((100, value_dim)).astype(np.float32)

    def jax_loss(params):
        (wa_, ba_), (wc_, bc_), (wm_, bm_, wv_, bv_) = params
        res = jfm.fused_mlp_pair_heads(jnp.asarray(xa), jnp.asarray(xc), wa_, ba_, wc_, bc_, wm_, bm_, wv_, bv_,
                                       "elu", True, use_pallas=True, block_rows=32, interpret=True,
                                       expose_latent=expose_latent)
        total = jnp.mean(res[0] * adv) + jnp.mean(jnp.square(res[1] - vtgt))
        if expose_latent:
            total = total + jnp.mean(res[2].astype(jnp.float32) ** 2)
        return total, res

    params = (_jax(wa, ba), _jax(wc, bc),
              (jnp.asarray(wm.T), jnp.asarray(bm[None]), jnp.asarray(wv.T), jnp.asarray(bv[None])))
    grads, jres = jax.grad(jax_loss, has_aux=True)(params)

    twa, tba, twc, tbc = _torch(*wa), _torch(*ba), _torch(*wc), _torch(*bc)
    twm, tbm, twv, tbv = _torch(wm, bm, wv, bv)
    res = tfm.fused_mlp_pair_heads(torch.from_numpy(xa), torch.from_numpy(xc), twa, tba, twc, tbc,
                                   twm, tbm, twv, tbv, "elu", True, expose_latent=expose_latent)
    assert len(res) == len(jres) and res[0].dtype == torch.float32 and res[1].shape == (100, value_dim)
    total = torch.mean(res[0] * torch.from_numpy(adv)) + torch.mean((res[1] - torch.from_numpy(vtgt)).square())
    if expose_latent:
        assert res[2].dtype == torch.bfloat16
        total = total + torch.mean(res[2].float() ** 2)
    total.backward()

    for got, want in zip(res, jres):
        np.testing.assert_allclose(_f32(got), _f32(want), **OUT_TOL)
    (gwa, gba), (gwc, gbc), (gwm, gbm, gwv, gbv) = grads
    for tw, tb, gw, gb in ((twa, tba, gwa, gba), (twc, tbc, gwc, gbc)):
        for w, g in zip(tw, gw):
            np.testing.assert_allclose(_f32(w.grad), np.asarray(g).T, **GRAD_TOL)
        for b, g in zip(tb, gb):
            np.testing.assert_allclose(_f32(b.grad), np.asarray(g)[0], **GRAD_TOL)
    for p, g in ((twm, gwm), (twv, gwv)):
        np.testing.assert_allclose(_f32(p.grad), np.asarray(g).T, **GRAD_TOL)
    for p, g in ((tbm, gbm), (tbv, gbv)):
        np.testing.assert_allclose(_f32(p.grad), np.asarray(g)[0], **GRAD_TOL)


def test_pair_heads_primal_writes_no_latent_and_counts_no_launch():
    rng = np.random.default_rng(3)
    (wa, ba), (wc, bc) = _chain(rng), _chain(rng)
    (wm, bm), (wv, bv) = _head(rng, 4), _head(rng, 1)
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]
    x = torch.from_numpy(rng.standard_normal((37, DIMS[0])).astype(np.float32))
    tfm.reset_launch_counts()
    with torch.no_grad():
        mean, value = tfm.fused_mlp_pair_heads(x, x, t(wa), t(ba), t(wc), t(bc), *t([wm, bm, wv, bv]))
        _, _, latent = tfm.fused_mlp_pair_heads(x, x, t(wa), t(ba), t(wc), t(bc), *t([wm, bm, wv, bv]),
                                                expose_latent=True)
    assert mean.shape == (37, 4) and value.shape == (37, 1) and latent.shape == (37, DIMS[-1])
    assert not any(tfm.LAUNCHES.values())


def _ppo_problem(seed, n, a_dim=6, v_dim=1):
    rng = np.random.default_rng(seed)
    (wa, ba), (wc, bc) = _chain(rng), _chain(rng)
    (wm, bm), (wv, bv) = _head(rng, a_dim), _head(rng, v_dim)
    std = np.exp(rng.standard_normal(a_dim) * 0.2).astype(np.float32)
    action = rng.standard_normal((n, a_dim)).astype(np.float32)
    # old logp of a nearby policy, so the clip boundary is exercised
    mean0 = (rng.standard_normal((n, a_dim)) * 0.1).astype(np.float32)
    z = (action - mean0) / std
    old_logp = np.sum(-0.5 * z * z - np.log(std) - 0.5 * math.log(2 * math.pi), -1, keepdims=True).astype(np.float32)
    rows = dict(
        xa=rng.standard_normal((n, DIMS[0])).astype(np.float32),
        xc=rng.standard_normal((n, DIMS[0])).astype(np.float32),
        action=action, old_logp=old_logp,
        advantage=rng.standard_normal((n, 1)).astype(np.float32),
        old_value=rng.standard_normal((n, v_dim)).astype(np.float32),
        returns=rng.standard_normal((n, v_dim)).astype(np.float32),
    )
    return (wa, ba, wc, bc, wm, bm, wv, bv, std), rows


@pytest.mark.parametrize("loss_clip", [None, 0.2])
@pytest.mark.parametrize("n", [96, 100])  # 100: the pad rows of 32-row tiles
def test_fused_ppo_step_matches_pallas(loss_clip, n):
    """Loss, the four metrics and every gradient (std's included) of the
    port's plain split step against the Pallas split kernel in interpret mode."""
    _ppo_step_matches_pallas(loss_clip, n)


@pytest.mark.parametrize("loss_clip", [None, 0.2])
@pytest.mark.parametrize("n", [96, 100])
def test_fused_ppo_step_mono_matches_pallas_mono(loss_clip, n, monkeypatch):
    """The same with ``CUSRL_TPU_PPO_MODE=mono`` on both sides (the module
    attribute ``_PPO_MODE``, read per call): the port's K9m plain version
    against ``_run_ppo_step`` in interpret mode (``_ppo_step_kernel``)."""
    monkeypatch.setattr(jfp, "_PPO_MODE", "mono")
    monkeypatch.setattr(tfp, "_PPO_MODE", "mono")
    _ppo_step_matches_pallas(loss_clip, n)


def _ppo_step_matches_pallas(loss_clip, n):
    (wa, ba, wc, bc, wm, bm, wv, bv, std), rows = _ppo_problem(20 + n, n)
    j_rows = {k: jnp.asarray(v) for k, v in rows.items()}

    def jax_run(params):
        (wa_, ba_), (wc_, bc_), (wm_, bm_, wv_, bv_, std_) = params
        return jfp.fused_ppo_step(
            j_rows["xa"], j_rows["xc"], wa_, ba_, wc_, bc_, wm_, bm_, wv_, bv_, std_,
            j_rows["action"], j_rows["old_logp"], j_rows["advantage"], j_rows["old_value"], j_rows["returns"],
            0.2, 1.0, 0.5, "elu", True, loss_clip=loss_clip, use_pallas=True, block_rows=32, interpret=True,
        )

    params = (_jax(wa, ba), _jax(wc, bc), (jnp.asarray(wm.T), jnp.asarray(bm[None]), jnp.asarray(wv.T),
                                           jnp.asarray(bv[None]), jnp.asarray(std)))
    (j_loss, j_metrics), grads = jax.value_and_grad(jax_run, has_aux=True)(params)

    twa, tba, twc, tbc = _torch(*wa), _torch(*ba), _torch(*wc), _torch(*bc)
    twm, tbm, twv, tbv, tstd = _torch(wm, bm, wv, bv, std)
    t_rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    loss, metrics = tfp.fused_ppo_step(
        t_rows["xa"], t_rows["xc"], twa, tba, twc, tbc, twm, tbm, twv, tbv, tstd,
        t_rows["action"], t_rows["old_logp"], t_rows["advantage"], t_rows["old_value"], t_rows["returns"],
        0.2, 1.0, 0.5, "elu", True, loss_clip=loss_clip,
    )
    assert all(not m.requires_grad for m in metrics)
    loss.backward()

    np.testing.assert_allclose(_f32(loss), np.asarray(j_loss), atol=1e-3, rtol=1e-3)
    for got, want in zip(metrics, j_metrics):
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=2e-3, rtol=2e-3)
    (gwa, gba), (gwc, gbc), (gwm, gbm, gwv, gbv, gstd) = grads
    for tw, tb, gw, gb in ((twa, tba, gwa, gba), (twc, tbc, gwc, gbc)):
        for w, g in zip(tw, gw):
            np.testing.assert_allclose(_f32(w.grad), np.asarray(g).T, **GRAD_TOL)
        for b, g in zip(tb, gb):
            np.testing.assert_allclose(_f32(b.grad), np.asarray(g)[0], **GRAD_TOL)
    for p, g in ((twm, gwm), (twv, gwv)):
        np.testing.assert_allclose(_f32(p.grad), np.asarray(g).T, **GRAD_TOL)
    for p, g in ((tbm, gbm), (tbv, gbv)):
        np.testing.assert_allclose(_f32(p.grad), np.asarray(g)[0], **GRAD_TOL)
    np.testing.assert_allclose(_f32(tstd.grad), np.asarray(gstd), **GRAD_TOL)


@pytest.mark.parametrize("loss_clip", [None, 0.2])
def test_fused_ppo_step_plain_matches_its_autograd_reference(loss_clip):
    """The explicit backward formulas against autograd of
    ``ppo_step_reference`` on the same inputs (fp32 losses; gradients one bf16
    rounding apart); the cotangent scales every gradient."""
    (wa, ba, wc, bc, wm, bm, wv, bv, std), rows = _ppo_problem(7, 64)
    t_rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    results = []
    for fn in (tfp.fused_ppo_step, tfp.ppo_step_reference):
        params = [_torch(*wa), _torch(*ba), _torch(*wc), _torch(*bc), *_torch(wm, bm, wv, bv, std)]
        out = fn(t_rows["xa"], t_rows["xc"], *params, t_rows["action"], t_rows["old_logp"], t_rows["advantage"],
                 t_rows["old_value"], t_rows["returns"], 0.2, 1.0, 0.5, "elu", True, loss_clip=loss_clip)
        (3.0 * out[0]).backward()
        flat = [*params[0], *params[1], *params[2], *params[3], *params[4:]]
        results.append((out[0], [p.grad for p in flat]))
    (loss_k, grads_k), (loss_r, grads_r) = results
    np.testing.assert_allclose(_f32(loss_k), _f32(loss_r), rtol=1e-5, atol=1e-6)
    for a, b in zip(grads_k, grads_r):
        np.testing.assert_allclose(_f32(a), _f32(b), **GRAD_TOL)


@pytest.mark.parametrize("loss_clip", [None, 0.2])
def test_fused_ppo_step_mono_equals_split_on_the_cpu(loss_clip, monkeypatch):
    """On CPU tensors mono's plain version (the chains' forward, then
    ``ppo_loss_bwd_plain``) is the split pair's arithmetic: the same loss,
    metrics and gradients, bit for bit, and no launch counted."""
    (wa, ba, wc, bc, wm, bm, wv, bv, std), rows = _ppo_problem(11, 100)
    t_rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    tfm.reset_launch_counts()
    results = {}
    for mode in ("split", "mono"):
        monkeypatch.setattr(tfp, "_PPO_MODE", mode)
        params = [*_torch(*wa), *_torch(*ba), *_torch(*wc), *_torch(*bc), *_torch(wm, bm, wv, bv, std)]
        nl = len(wa)
        loss, metrics = tfp.fused_ppo_step(
            t_rows["xa"], t_rows["xc"], params[:nl], params[nl:2 * nl], params[2 * nl:3 * nl], params[3 * nl:4 * nl],
            *params[4 * nl:], t_rows["action"], t_rows["old_logp"], t_rows["advantage"], t_rows["old_value"],
            t_rows["returns"], 0.2, 1.0, 0.5, "elu", True, loss_clip=loss_clip,
        )
        (2.0 * loss).backward()
        results[mode] = (torch.stack([loss, *metrics]).detach(), [p.grad for p in params])
    assert not any(tfm.LAUNCHES.values())
    (split, split_grads), (mono, mono_grads) = results["split"], results["mono"]
    torch.testing.assert_close(mono, split, rtol=0, atol=0)
    for a, b in zip(mono_grads, split_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mono_plain_is_the_forward_then_the_split_loss_backward():
    """``ppo_step_mono_plain`` (K9m's oracle on the card) against the chains'
    plain forward followed by ``ppo_loss_bwd_plain`` (K9s's)."""
    (wa, ba, wc, bc, wm, bm, wv, bv, std), rows = _ppo_problem(12, 70)
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]
    xs = [torch.from_numpy(rows["xa"]), torch.from_numpy(rows["xc"])]
    hss = []
    for x, ws, bs in zip(xs, (t(wa), t(wc)), (t(ba), t(bc))):
        out, hidden = tfm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
        hss.append([*hidden, out])
    loss_rows = [torch.from_numpy(rows[k]) for k in ("action",)] + [
        torch.from_numpy(rows["old_logp"]).reshape(-1), torch.from_numpy(rows["advantage"]).reshape(-1),
        torch.from_numpy(rows["old_value"]), torch.from_numpy(rows["returns"])]
    heads = [torch.from_numpy(a) for a in (wm, bm, wv, bv, std)]
    args = (*heads, *loss_rows, 0.2, 1.0, 0.5, 0.2, "elu", True)
    got = tfp.ppo_step_mono_plain(xs, [t(ba), t(bc)], [t(wa), t(wc)], *args)
    want = tfp.ppo_loss_bwd_plain(xs, hss, [t(wa), t(wc)], *args)
    flat = lambda r: [*(x for g in r[0][:4] for x in g), *r[0][4:], r[1]]
    for a, b in zip(flat(got), flat(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
