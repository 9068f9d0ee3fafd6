"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present (decided inside a
fixture, so every worker collects the same tests).  On a machine with a card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Tolerances: bf16 outputs within 2e-2 (a neighbouring bf16 rounding, since the
kernel accumulates in another order); gradients within 1e-2 of the largest
plain value (fp32 sums of bf16 products, with a rounding of d that can flip).
"""

import math

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

pytestmark = pytest.mark.gpu

WIDTHS = (48, 512, 256, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(gen, device, widths=WIDTHS):
    ws = [(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device) for a, b in zip(widths[:-1], widths[1:])]
    bs = [(torch.randn(b, generator=gen) * 0.1).to(device) for b in widths[1:]]
    return ws, bs


def _close(got, want, grad: bool):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if grad:
        assert (got - want).abs().max() <= 1e-2 * want.abs().max()
    else:
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rows", [4096, 1000, 37])
@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "identity"])
def test_forward_matches_plain(cuda, rows, activation):
    gen = torch.Generator().manual_seed(rows)
    ws, bs = _params(gen, cuda)
    x = torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda)
    for trailing in (True, False):
        (out,), (hid,), _ = fm._launch_fwd([x], [ws], [bs], activation, trailing, True, "K1f")
        ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, activation, trailing, True)
        _close(out, ref, grad=False)
        for h, r in zip(hid, ref_hid):
            _close(h, r, grad=False)


@pytest.mark.parametrize("rows", [24576, 1000])
@pytest.mark.parametrize("chains", [1, 2])
def test_backward_matches_plain(cuda, rows, chains):
    gen = torch.Generator().manual_seed(rows + chains)
    params = [_params(gen, cuda) for _ in range(chains)]
    wss, bss = [p[0] for p in params], [p[1] for p in params]
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(chains)]
    gs = [(torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(cuda, torch.bfloat16) for _ in range(chains)]
    outs, hids, _ = fm._launch_fwd(xs, wss, bss, "elu", True, True, "K2f")
    hss = [[*h, o] for h, o in zip(hids, outs)]
    for skip in (False, True):
        got = fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, "K2b")
        for c, (dx, dws, dbs, _) in enumerate(got):
            rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], gs[c], wss[c], hss[c], "elu", True, skip)
            for a, b in zip([*dws, *dbs], [*rdws, *rdbs]):
                _close(a, b, grad=True)
            assert (dx is None) == skip
            if not skip:
                _close(dx, rdx, grad=True)


def _leaf_params(gen, device):
    ws, bs = _params(gen, device)
    return [w.requires_grad_() for w in ws], [b.requires_grad_() for b in bs]


def _plain_grads(x, ws, bs, g, skip):
    with torch.no_grad():
        out, hid = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
        return out, fm.mlp_chain_bwd_plain(x, g, ws, [*hid, out], "elu", True, skip)


@pytest.mark.parametrize("rows", [4096, 98304])
def test_fused_mlp_no_grad_matches_plain(cuda, rows):
    gen = torch.Generator().manual_seed(rows)
    ws, bs = _leaf_params(gen, cuda)
    x = torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda)
    with torch.no_grad():
        out = fm.fused_mlp(x, ws, bs)
    _close(out, fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, False)[0], grad=False)


def test_fused_mlp_autograd_matches_plain(cuda):
    gen = torch.Generator().manual_seed(1)
    ws, bs = _leaf_params(gen, cuda)
    x = torch.tanh(torch.randn(1000, WIDTHS[0], generator=gen)).to(cuda).requires_grad_()
    g = (torch.randn(1000, WIDTHS[-1], generator=gen) * 0.01).to(cuda, torch.bfloat16)
    out = fm.fused_mlp(x, ws, bs)
    out.backward(g)
    ref, (rdx, rdws, rdbs) = _plain_grads(x.detach(), ws, bs, g, False)
    _close(out, ref, grad=False)
    assert x.grad.dtype == x.dtype
    for got, want in zip([x.grad, *(w.grad for w in ws), *(b.grad for b in bs)], [rdx, *rdws, *rdbs]):
        _close(got, want, grad=True)


@pytest.mark.parametrize("rows", [24576, 1000])
def test_fused_mlp_pair_autograd_matches_plain(cuda, rows):
    gen = torch.Generator().manual_seed(rows + 7)
    (wa, ba), (wc, bc) = _leaf_params(gen, cuda), _leaf_params(gen, cuda)
    xa, xc = (torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2))
    ga, gc = ((torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(cuda, torch.bfloat16) for _ in range(2))
    out_a, out_c = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, skip_input_grad=True)
    torch.autograd.backward([out_a, out_c], [ga, gc])
    for x, ws, bs, g, out in ((xa, wa, ba, ga, out_a), (xc, wc, bc, gc, out_c)):
        ref, (rdx, rdws, rdbs) = _plain_grads(x, ws, bs, g, True)
        assert rdx is None
        _close(out, ref, grad=False)
        for got, want in zip([*(w.grad for w in ws), *(b.grad for b in bs)], [*rdws, *rdbs]):
            _close(got, want, grad=True)
    # Only the actor's output used: the critic's cotangent is the zero fill.
    for p in (*wa, *ba, *wc, *bc):
        p.grad = None
    out_a, _ = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, skip_input_grad=True)
    out_a.backward(ga)
    _, (_, rdws, rdbs) = _plain_grads(xa, wa, ba, ga, True)
    for got, want in zip([*(w.grad for w in wa), *(b.grad for b in ba)], [*rdws, *rdbs]):
        _close(got, want, grad=True)
    assert all(p.grad is None or not p.grad.any() for p in (*wc, *bc))


def test_autograd_wrappers_launch_and_count(cuda):
    gen = torch.Generator().manual_seed(0)
    ws, bs = _params(gen, cuda)
    for t in (*ws, *bs):
        t.requires_grad_(True)
    x = torch.tanh(torch.randn(512, WIDTHS[0], generator=gen)).to(cuda)
    fm.reset_launch_counts()
    out = fm.fused_mlp(x, ws, bs)
    out.float().square().mean().backward()
    a, c = fm.fused_mlp_pair(x, x, ws, bs, ws, bs, skip_input_grad=True)
    (a.float().sum() + c.float().sum()).backward()
    with torch.no_grad():
        fm.fused_mlp(x, ws, bs)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {"K1f": 2, "K1b": 1, "K2f": 1, "K2b": 1, "K8f": 0, "K8b": 0, "K9s": 0}


def test_unsupported_width_raises_on_cuda(cuda):
    x = torch.zeros(64, 40, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        fm.fused_mlp(x, [torch.zeros(64, 40, device=cuda)], [torch.zeros(64, device=cuda)])


# -- K8f/K8b (pair + heads) and K9s (PPO loss backward) ------------------------

A_DIM = 12


def _heads(gen, device, value_dim=1):
    return [((torch.randn(d, WIDTHS[-1], generator=gen) * 0.2).to(device), (torch.randn(d, generator=gen) * 0.1).to(device))
            for d in (A_DIM, value_dim)]


@pytest.mark.parametrize("rows", [24576, 1000])
@pytest.mark.parametrize("value_dim", [1, 3])
def test_pair_heads_launchers_match_plain(cuda, rows, value_dim):
    gen = torch.Generator().manual_seed(rows + value_dim)
    (wa, ba), (wc, bc) = _params(gen, cuda), _params(gen, cuda)
    heads = _heads(gen, cuda, value_dim)
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2)]
    for save in (False, True):
        outs, hids, head_outs = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, save, "K8f", heads=heads)
        for c, (x, ws, bs, (w, b)) in enumerate(zip(xs, [wa, wc], [ba, bc], heads)):
            ref, ref_lat, ref_hid = fm.pair_heads_fwd_plain(x, ws, bs, w, b, "elu", True, save)
            _close(head_outs[c], ref, grad=False)
            assert (outs[c] is None) != save
            if save:
                _close(outs[c], ref_lat, grad=False)
                for h, r in zip(hids[c], ref_hid):
                    _close(h, r, grad=False)
    outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K8f", heads=heads)
    hss = [[*h, o] for h, o in zip(hids, outs)]
    gm = (torch.randn(rows, A_DIM, generator=gen) * 0.01).to(cuda)
    gv = (torch.randn(rows, value_dim, generator=gen) * 0.01).to(cuda)
    gl = (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(cuda)
    for expose, skip in ((False, True), (True, True), (True, False)):
        spec = [(heads[0][0], None, gm, gl if expose else None), (heads[1][0], None, gv, None)]
        got = fm._launch_bwd(xs, None, [wa, wc], hss, "elu", True, skip, "K8b", heads=spec)
        for c, (dx, dws, dbs, (dwh, dbh)) in enumerate(got):
            w, _, g, g_lat = spec[c]
            d, rdwh, rdbh = fm.head_bwd_plain(hss[c][-1], g, w, g_lat)
            rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], d, [wa, wc][c], hss[c], "elu", True, skip)
            for a, b in zip([*dws, *dbs, dwh, dbh], [*rdws, *rdbs, rdwh, rdbh]):
                _close(a, b, grad=True)
            assert (dx is None) == skip
            if not skip:
                _close(dx, rdx, grad=True)


@pytest.mark.parametrize("rows", [24576, 1000])
@pytest.mark.parametrize("loss_clip", [None, 0.2])
def test_loss_bwd_matches_plain(cuda, rows, loss_clip):
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(rows + 3)
    (wa, ba), (wc, bc) = _params(gen, cuda), _params(gen, cuda)
    (wm, bm), (wv, bv) = _heads(gen, cuda)
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2)]
    outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f")
    hss = [[*h, o] for h, o in zip(hids, outs)]
    std = torch.exp(torch.randn(A_DIM, generator=gen) * 0.2).to(cuda)
    with torch.no_grad():
        mean = hss[0][-1].float() @ wm.T + bm
    action = mean + std * torch.randn(rows, A_DIM, generator=gen).to(cuda)
    old_logp = (-0.5 * ((action - mean) / std).square() - torch.log(std) - 0.9189385332046727).sum(-1)
    old_logp = old_logp + (torch.randn(rows, generator=gen) * 0.2).to(cuda)
    adv = torch.randn(rows, generator=gen).to(cuda)
    ret = torch.randn(rows, 1, generator=gen).to(cuda)
    old_value = torch.randn(rows, 1, generator=gen).to(cuda)
    args = (xs, hss, [wa, wc], wm, bm, wv, bv, std, action, old_logp, adv, old_value, ret, 0.2, 1.0, 0.5,
            loss_clip, "elu", True)
    got, sums = fp._loss_bwd(*args)
    want, ref_sums = fp.ppo_loss_bwd_plain(*args)
    flat = lambda g: [*g[0], *g[1], *g[2], *g[3], *g[4:]]
    # A row at a clip bound may take the other branch on one side: 3e-2 of
    # the largest value, the JAX package's own rtol for this kernel.
    for a, b in zip(flat(got), flat(want)):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all() and (a - b).abs().max() <= 3e-2 * b.abs().max()
    assert torch.isfinite(sums).all()
    assert ((sums - ref_sums).abs() <= 1e-4 * ref_sums.abs().clamp(min=1.0)).all(), (sums, ref_sums)


def test_head_wrappers_match_plain_under_autograd(cuda):
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(5)
    rows = 1000
    (wa, ba), (wc, bc) = _leaf_params(gen, cuda), _leaf_params(gen, cuda)
    (wm, bm), (wv, bv) = [(w.requires_grad_(), b.requires_grad_()) for w, b in _heads(gen, cuda)]
    xa, xc = (torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2))
    params = [*wa, *ba, *wc, *bc, wm, bm, wv, bv]

    def grads_of(fn):
        for p in params:
            p.grad = None
        fn().backward()
        return [p.grad.clone() for p in params]

    gm = (torch.randn(rows, A_DIM, generator=gen) * 0.01).to(cuda)
    kernel = grads_of(lambda: (fm.fused_mlp_pair_heads(xa, xc, wa, ba, wc, bc, wm, bm, wv, bv)[0] * gm).sum())
    cpu_params = [p.detach().cpu().requires_grad_() for p in params]
    nl = len(wa)
    cw = [cpu_params[:nl], cpu_params[nl:2 * nl], cpu_params[2 * nl:3 * nl], cpu_params[3 * nl:4 * nl]]
    out = fm.fused_mlp_pair_heads(xa.cpu(), xc.cpu(), *cw, *cpu_params[4 * nl:])[0]
    (out * gm.cpu()).sum().backward()
    for a, p in zip(kernel, cpu_params):
        _close(a.cpu(), p.grad, grad=True)

    std = torch.exp(torch.randn(A_DIM, generator=gen) * 0.2).to(cuda).requires_grad_()
    with torch.no_grad():
        mean = fm.fused_mlp_pair_heads(xa, xc, wa, ba, wc, bc, wm, bm, wv, bv)[0]
    action = mean + std.detach() * torch.randn(rows, A_DIM, generator=gen).to(cuda)
    old_logp = (-0.5 * ((action - mean) / std.detach()).square() - torch.log(std.detach())).sum(-1) - 11.027
    old_logp = old_logp + (torch.randn(rows, generator=gen) * 0.2).to(cuda)
    rows_data = (action, old_logp, torch.randn(rows, 1, generator=gen).to(cuda), None,
                 torch.randn(rows, 1, generator=gen).to(cuda))
    loss, metrics = fp.fused_ppo_step(xa, xc, wa, ba, wc, bc, wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5)
    for p in (*params, std):
        p.grad = None
    loss.backward()
    cpu_std = std.detach().cpu().requires_grad_()
    for p in cpu_params:
        p.grad = None
    c_loss, c_metrics = fp.fused_ppo_step(xa.cpu(), xc.cpu(), *cw, *cpu_params[4 * nl:], cpu_std,
                                          *(None if t is None else t.cpu() for t in rows_data), 0.2, 1.0, 0.5)
    c_loss.backward()
    assert abs(loss.item() - c_loss.item()) <= 1e-3 * max(1.0, abs(c_loss.item()))
    for m, c in zip(metrics, c_metrics):
        assert abs(m.item() - c.item()) <= 2e-3 * max(1.0, abs(c.item()))
    for a, p in zip([*params, std], [*cpu_params, cpu_std]):  # 3e-2: as in test_loss_bwd_matches_plain
        assert (a.grad.cpu() - p.grad).abs().max() <= 3e-2 * p.grad.abs().max()


# -- K1 with gelu (the transformer FFN) ---------------------------------------

FFN_WIDTHS = (128, 512, 128)


@pytest.mark.parametrize("rows", [1024, 6144, 1000])
def test_gelu_chain_matches_plain(cuda, rows):
    """K1f saving gelu's pre-activations and K1b recomputing gelu' from them,
    at the FFN's widths (1,024-row rollout step, 6,144-row minibatch)."""
    gen = torch.Generator().manual_seed(rows + 11)
    ws, bs = _params(gen, cuda, FFN_WIDTHS)
    x = torch.randn(rows, FFN_WIDTHS[0], generator=gen).to(cuda, torch.bfloat16)
    g = (torch.randn(rows, FFN_WIDTHS[-1], generator=gen) * 0.01).to(cuda, torch.bfloat16)
    (out,), (hid,), _ = fm._launch_fwd([x], [ws], [bs], "gelu", False, True, "K1f")
    ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, "gelu", False, True)
    _close(out, ref, grad=False)
    _close(hid[0], ref_hid[0], grad=False)  # the bf16 pre-activation z
    ((dx, dws, dbs, _),) = fm._launch_bwd([x], [g], [ws], [[*hid, out]], "gelu", False, False, "K1b")
    rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(x, g, ws, [*ref_hid, ref], "gelu", False, False)
    for a, b in zip([dx, *dws, *dbs], [rdx, *rdws, *rdbs]):
        _close(a, b, grad=True)


# -- K3f/K3b (lane window attention) and K6 (next-token attention) ------------


def _lane_inputs(gen, device, n, heads=4, t_len=24, window=16, dim=32, invalid=False):
    s_len = window + t_len
    q = torch.randn(n, heads, t_len, dim, generator=gen).to(device, torch.bfloat16)
    k = torch.randn(n, heads, s_len, dim, generator=gen).to(device, torch.bfloat16)
    v = torch.randn(n, heads, s_len, dim, generator=gen).to(device, torch.bfloat16)
    done = torch.rand(n, t_len, generator=gen) < 0.1
    q_seg = torch.cumsum(torch.cat([torch.zeros(n, 1, dtype=torch.int32), done[:, :-1].int()], 1), 1,
                         dtype=torch.int32)
    k_seg = torch.cat([torch.zeros(n, window, dtype=torch.int32), q_seg], 1)
    k_valid = torch.cat([(torch.rand(n, window, generator=gen) < 0.5).int(), torch.ones(n, t_len, dtype=torch.int32)],
                        1)
    if invalid:  # rows that see no valid key at all
        k_valid[: n // 3] = 0
    return [t.to(device) for t in (q, k, v, q_seg, k_seg, k_valid)]


# Attention outputs and gradients are fp32 sums over at most W+1 terms of
# bf16 inputs: the kernel and the plain version differ only in the order.
ATT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,t_len,window,slopes", [(256, 24, 16, None), (1024, 24, 16, None),
                                                   (130, 5, 4, (0.5, 0.25, 0.125, 0.0625))])
def test_lane_kernels_match_plain(cuda, n, t_len, window, slopes):
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(n + t_len)
    q, k, v, *masks = _lane_inputs(gen, cuda, n, t_len=t_len, window=window, invalid=slopes is not None)
    for save in (False, True):
        out, probs = la._launch_fwd(q, k, v, *masks, window, slopes, save)
        ref, ref_probs = la.lane_fwd_plain(q, k, v, *masks, window, slopes, save)
        torch.testing.assert_close(out, ref, **ATT_TOL)
        assert (probs is None) != save
        if save:
            torch.testing.assert_close(probs, ref_probs, **ATT_TOL)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    got = la._launch_bwd(q, k, v, ref_probs, g, *masks, window)
    for a, b in zip(got, la.lane_bwd_plain(q, k, v, ref_probs, g, window)):
        torch.testing.assert_close(a, b, **ATT_TOL)
    k_self, v_self = (torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16) for _ in range(2))
    out = la._launch_next(q, k_self, v_self, k, v, *masks, window, slopes)
    torch.testing.assert_close(out, la.next_token_plain(q, k_self, v_self, k, v, *masks, window, slopes), **ATT_TOL)
    if slopes is not None:
        assert not out.isnan().any() and not la._launch_fwd(q, k, v, *masks, window, slopes, False)[0][: n // 3].any()


def test_lane_autograd_wrapper_matches_plain_and_counts(cuda):
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(3)
    q, k, v, *masks = _lane_inputs(gen, cuda, 256)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    la.reset_launch_counts()
    out = la.lane_window_attention(*leaves, *masks, window=16)
    out.backward(g)
    with torch.no_grad():
        primal = la.lane_window_attention(q, k, v, *masks, window=16)
    torch.cuda.synchronize()
    assert la.LAUNCHES == {"K3f": 2, "K3b": 1, "K6": 0}
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ref = la.lane_window_attention(*cpu, *(m.cpu() for m in masks), window=16)
    ref.backward(g.cpu())
    torch.testing.assert_close(out.cpu(), ref, **ATT_TOL)
    torch.testing.assert_close(primal, out.detach(), rtol=0, atol=0)
    for a, b in zip(leaves, cpu):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float().cpu(), b.grad.float(), rtol=1e-2, atol=1e-2)
