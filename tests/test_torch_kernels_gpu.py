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
    assert fm.LAUNCHES == {"K1f": 2, "K1b": 1, "K2f": 1, "K2b": 1, "K8f": 0, "K8b": 0, "K9s": 0, "K9m": 0}


def test_unsupported_width_raises_on_cuda(cuda):
    """A hidden or output width that is not a multiple of 16 raises (the
    input width may be any, up to 512)."""
    x = torch.zeros(64, 40, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        fm.fused_mlp(x, [torch.zeros(40, 40, device=cuda)], [torch.zeros(40, device=cuda)])
    with pytest.raises(ValueError, match="up to 512"):
        fm.fused_mlp(torch.zeros(64, 520, device=cuda), [torch.zeros(64, 520, device=cuda)],
                     [torch.zeros(64, device=cuda)])


# -- K1f/K2f/K8f: the wgmma forward at every shape the wrapper takes ---------

EIGHT_LAYERS = (512, 16, 512, 48, 80, 128, 256, 512, 16)


def _flat(obj) -> list:
    """The tensors in a nest of lists and tuples, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for item in obj for t in _flat(item)] if isinstance(obj, (list, tuple)) else []


def _check_chain_fwd(xs, wss, bss, activation, trailing, save, counter="K1f"):
    """Each chain of one launch against the plain version; returns the launch's outputs."""
    outs, hids, _ = fm._launch_fwd(xs, wss, bss, activation, trailing, save, counter)
    for x, ws, bs, out, hid in zip(xs, wss, bss, outs, hids):
        ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, activation, trailing, save)
        _close(out, ref, grad=False)
        assert len(hid) == len(ref_hid)
        for h, r in zip(hid, ref_hid):
            _close(h, r, grad=False)
    return outs, hids


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 1024, 98304 + 37])
def test_chain_forward_at_ragged_rows(cuda, rows, chains, x_dtype):
    """Rows that end inside a 64-row tile load as 0 and are not stored; the
    main path's widths stream their 24 images through the ring."""
    gen = torch.Generator().manual_seed(rows + 3 * chains)
    params = [_params(gen, cuda) for _ in range(chains)]
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda, x_dtype) for _ in range(chains)]
    for save in (True, False):
        _check_chain_fwd(xs, [p[0] for p in params], [p[1] for p in params], "elu", True, save,
                         "K1f" if chains == 1 else "K2f")


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "gelu", "identity"])
def test_chain_forward_every_activation(cuda, activation, x_dtype):
    """Each activation at the main path's widths (streamed) and the
    transformer head's 128 -> 128 (resident), with and without the trailing
    activation (gelu: without, the JAX rule)."""
    gen = torch.Generator().manual_seed(len(activation))
    for widths in (WIDTHS, (128, 128)):
        ws, bs = _params(gen, cuda, widths)
        x = torch.tanh(torch.randn(1000, widths[0], generator=gen)).to(cuda, x_dtype)
        for trailing in ((False,) if activation == "gelu" else (True, False)):
            _check_chain_fwd([x], [ws], [bs], activation, trailing, True)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(16, 16), (48, 80, 48), (512, 512), (16, 512, 16), (80, 16, 512), (128, 128),
                                    (512, 16), EIGHT_LAYERS])
def test_chain_forward_at_the_width_limits(cuda, widths, x_dtype):
    """Widths 16 to 512 (multiples of 16 that are not of 64 pad with zeros),
    1 to 8 layers, resident and streamed images, one and two chains."""
    gen = torch.Generator().manual_seed(sum(widths))
    for chains in (1, 2):
        params = [_params(gen, cuda, widths) for _ in range(chains)]
        xs = [torch.tanh(torch.randn(1000, widths[0], generator=gen)).to(cuda, x_dtype) for _ in range(chains)]
        _check_chain_fwd(xs, [p[0] for p in params], [p[1] for p in params], "tanh", True, True,
                         "K1f" if chains == 1 else "K2f")


@pytest.mark.parametrize("rows", [1024, 1000])
@pytest.mark.parametrize("head_dim", [1, 12, 64])
def test_pair_heads_forward_at_head_widths(cuda, head_dim, rows):
    """K8f's fp32 heads 1 to 64 wide on the latent tile, with and without the
    saved latent and hiddens."""
    gen = torch.Generator().manual_seed(head_dim + rows)
    (wa, ba), (wc, bc) = _params(gen, cuda), _params(gen, cuda)
    heads = [((torch.randn(head_dim, WIDTHS[-1], generator=gen) * 0.2).to(cuda),
              (torch.randn(head_dim, generator=gen) * 0.1).to(cuda)) for _ in range(2)]
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2)]
    for save in (False, True):
        outs, hids, head_outs = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, save, "K8f", heads=heads)
        for c, (x, ws, bs, (w, b)) in enumerate(zip(xs, [wa, wc], [ba, bc], heads)):
            ref, ref_lat, ref_hid = fm.pair_heads_fwd_plain(x, ws, bs, w, b, "elu", True, save)
            assert head_outs[c].shape == (rows, head_dim) and head_outs[c].dtype == torch.float32
            _close(head_outs[c], ref, grad=False)
            assert (outs[c] is None) != save
            if save:
                _close(outs[c], ref_lat, grad=False)
                for h, r in zip(hids[c], ref_hid):
                    _close(h, r, grad=False)


def test_chain_forwards_repeat_bitwise(cuda):
    """Two calls of K1f (streamed and resident), K2f and K8f on the same
    inputs give the same bits."""
    gen = torch.Generator().manual_seed(47)
    (wa, ba), (wc, bc) = _params(gen, cuda), _params(gen, cuda)
    head_w, head_b = _params(gen, cuda, (128, 128))
    heads = _heads(gen, cuda)
    xs = [torch.tanh(torch.randn(24576 + 17, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2)]
    xh = torch.randn(65536 + 5, 128, generator=gen).to(cuda, torch.bfloat16)
    calls = [lambda: fm._launch_fwd(xs[:1], [wa], [ba], "elu", True, True, "K1f"),
             lambda: fm._launch_fwd([xh], [head_w], [head_b], "elu", True, False, "K1f"),
             lambda: fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f"),
             lambda: fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, False, "K8f", heads=heads)]
    for call in calls:
        first, second = _flat(call()), _flat(call())
        assert first and len(first) == len(second)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_chain_forward_follows_weights_changed_in_place(cuda):
    """Weights updated in place between two calls (as the optimizer does):
    the second call converts or packs them afresh."""
    gen = torch.Generator().manual_seed(53)
    for widths in (WIDTHS, (128, 128)):
        ws, bs = _params(gen, cuda, widths)
        x = torch.tanh(torch.randn(6144, widths[0], generator=gen)).to(cuda)
        (out0,), _ = _check_chain_fwd([x], [ws], [bs], "elu", True, False)
        for t in (*ws, *bs):
            t.add_(0.05 * torch.randn(t.shape, generator=gen).to(cuda))
        (out1,), _ = _check_chain_fwd([x], [ws], [bs], "elu", True, False)
        assert not torch.equal(out0, out1)


def test_chain_forward_plan_matches_the_python_mirror(cuda):
    """``mlpf::plan`` against ``weight_images.chain_plan`` (the images the
    wrapper allocates, resident or streamed, the grid the schedule assumes)
    and the card's shared memory."""
    from cusrl_tpu_torch.nn.kernels import weight_images as wi

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for widths in (WIDTHS, (128, 512, 128), (128, 128), (16, 16), (512, 16), EIGHT_LAYERS):
        for rows, chains in ((1, 1), (1024, 1), (24576, 2), (98304 + 37, 1), (262144, 1)):
            plan = fm.fwd_plan(widths, rows, chains)
            assert plan == wi.chain_plan(tuple(widths), rows, chains, sms)
            assert plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    assert fm.fwd_plan(WIDTHS, 98304, 1)["resident"] == 0  # the main path's 24 images stream
    assert fm.fwd_plan((128, 128), 262144, 1)["resident"] == 1  # the transformer head's 2 stay


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


# -- K4/K5 (fused transformer block) and K2b with input gradients -------------

BLOCK_IN, BLOCK_EMBED, BLOCK_FF = 48, 128, 512  # Velocity-Flat transformer_ppo


def _block_params(gen, device):
    """(pre params, post params) in the order ``fused_block_pre`` /
    ``fused_block_post`` take them."""
    def w(out, inp):
        return (torch.randn(out, inp, generator=gen) / math.sqrt(inp)).to(device)

    def v(n, base=0.0):
        return (base + torch.randn(n, generator=gen) * 0.1).to(device)

    e, f = BLOCK_EMBED, BLOCK_FF
    pre = (w(e, BLOCK_IN), v(e), v(e, 1.0), v(e), w(e, e), w(e, e), w(e, e), v(e), v(e), v(e))
    post = (w(e, e), v(e), v(e, 1.0), v(e), w(f, e), v(f), w(e, f), v(e))
    return pre, post


@pytest.mark.parametrize("rows,chains,skip", [(6144, 1, True), (1000, 1, False), (6144, 2, True), (37, 2, False)])
def test_block_pre_kernels_match_plain(cuda, rows, chains, skip):
    """The pre forward and backward (one layer: K4, the pair: K5), at the
    minibatch's rows and ragged ones, with and without dX; the backward is
    held from the plain forward's h on both sides."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(rows + chains)
    pss = [_block_params(gen, cuda)[0] for _ in range(chains)]
    xs = [torch.tanh(torch.randn(rows, BLOCK_IN, generator=gen)).to(cuda) for _ in range(chains)]
    hs, qkvs = fb._launch_pre_fwd(xs, pss, fb._counter("pre_f", chains))
    refs = [fb.pre_fwd_plain(x, *ps) for x, ps in zip(xs, pss)]
    for h, qkv, (rh, rqkv) in zip(hs, qkvs, refs):
        assert h.dtype == torch.float32 and torch.equal(h, h.to(torch.bfloat16).float())
        _close(h, rh, grad=False)
        _close(qkv, rqkv, grad=False)
    ghs = [(torch.randn(rows, BLOCK_EMBED, generator=gen) * 0.01).to(cuda) for _ in range(chains)]
    gqkvs = [(torch.randn(rows, 3 * BLOCK_EMBED, generator=gen) * 0.01).to(cuda, torch.bfloat16) for _ in range(chains)]
    rhs = [r[0] for r in refs]
    got = fb._launch_pre_bwd(xs, rhs, ghs, gqkvs, pss, skip, fb._counter("pre_b", chains))
    for c, result in enumerate(got):
        ps = pss[c]
        want = fb.pre_bwd_plain(xs[c], rhs[c], ghs[c], gqkvs[c], ps[0], *ps[4:7], ps[2], ps[3], skip)
        assert (result[0] is None) == skip
        for a, b in zip(result, want):
            if b is not None:
                _close(a, b, grad=True)


@pytest.mark.parametrize("rows,chains,activation", [(6144, 1, "gelu"), (1000, 1, "elu"), (6144, 2, "gelu"),
                                                    (1000, 2, "identity")])
def test_block_post_kernels_match_plain(cuda, rows, chains, activation):
    """The post forward, saving and primal, and backward (K4 / K5), the
    backward from the plain forward's saved r1 and activations."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(rows + 7 * chains)
    pss = [_block_params(gen, cuda)[1] for _ in range(chains)]
    attns = [torch.randn(rows, BLOCK_EMBED, generator=gen).to(cuda) for _ in range(chains)]
    hs = [torch.randn(rows, BLOCK_EMBED, generator=gen).to(cuda, torch.bfloat16).float() for _ in range(chains)]
    refs = [fb.post_fwd_plain(a, h, *ps, activation, True) for a, h, ps in zip(attns, hs, pss)]
    for save in (True, False):
        outs, r1s, saveds = fb._launch_post_fwd(attns, hs, pss, activation, save, fb._counter("post_f", chains))
        for c, (out, r1, saved) in enumerate(zip(outs, r1s, saveds)):
            _close(out, refs[c][0], grad=False)
            assert (r1 is None) != save and (saved is None) != save
            if save:
                _close(r1, refs[c][1], grad=False)
                _close(saved, refs[c][2], grad=False)
    gs = [(torch.randn(rows, BLOCK_EMBED, generator=gen) * 0.01).to(cuda, torch.bfloat16) for _ in range(chains)]
    wss = [(ps[0], ps[4], ps[6], ps[2], ps[3]) for ps in pss]
    got = fb._launch_post_bwd(attns, gs, [r[1] for r in refs], [r[2] for r in refs], wss, activation,
                              fb._counter("post_b", chains))
    for c, result in enumerate(got):
        want = fb.post_bwd_plain(attns[c], gs[c], refs[c][1], refs[c][2], *wss[c], activation)
        for a, b in zip(result, want):
            _close(a, b, grad=True)


def _block_params_at(gen, device, in_dim, embed, ff):
    """(pre params, post params) at any widths the kernels take."""
    def w(out, inp):
        return (torch.randn(out, inp, generator=gen) / math.sqrt(inp)).to(device)

    def v(n, base=0.0):
        return (base + torch.randn(n, generator=gen) * 0.1).to(device)

    e, f = embed, ff
    return ((w(e, in_dim), v(e), v(e, 1.0), v(e), w(e, e), w(e, e), w(e, e), v(e), v(e), v(e)),
            (w(e, e), v(e), v(e, 1.0), v(e), w(f, e), v(f), w(e, f), v(e)))


def _check_pre_fwd(xs, pss):
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    hs, qkvs = fb._launch_pre_fwd(xs, pss, fb._counter("pre_f", len(xs)))
    for x, ps, h, qkv in zip(xs, pss, hs, qkvs):
        rh, rqkv = fb.pre_fwd_plain(x, *ps)
        assert h.dtype == torch.float32 and torch.equal(h, h.to(torch.bfloat16).float())
        _close(h, rh, grad=False)
        _close(qkv, rqkv, grad=False)
    return hs, qkvs


def _check_post_fwd(attns, hs, pss, activation):
    """Saving and primal, each against the plain version; returns the saving outputs."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    refs = [fb.post_fwd_plain(a, h, *ps, activation, True) for a, h, ps in zip(attns, hs, pss)]
    results = {}
    for save in (True, False):
        outs, r1s, saveds = fb._launch_post_fwd(attns, hs, pss, activation, save, fb._counter("post_f", len(attns)))
        for ref, out, r1, saved in zip(refs, outs, r1s, saveds):
            _close(out, ref[0], grad=False)
            assert (r1 is None) != save and (saved is None) != save
            if save:
                _close(r1, ref[1], grad=False)
                _close(saved, ref[2], grad=False)
        results[save] = (outs, r1s, saveds)
    return results[True]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 6144 + 17, 65536 + 37])
def test_block_pre_forward_at_ragged_rows(cuda, rows, chains, x_dtype):
    """The redesigned pre forward (128-row tiles, resident weight images) at
    row counts that end inside a tile and inside a warpgroup's 64 rows."""
    gen = torch.Generator().manual_seed(rows + 3 * chains)
    pss = [_block_params(gen, cuda)[0] for _ in range(chains)]
    xs = [torch.tanh(torch.randn(rows, BLOCK_IN, generator=gen)).to(cuda, x_dtype) for _ in range(chains)]
    _check_pre_fwd(xs, pss)


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 6144 + 17, 65536 + 37])
def test_block_post_forward_at_ragged_rows(cuda, rows, chains):
    """The redesigned post forward (weight images streamed through the ring),
    saving and primal, at ragged row counts."""
    gen = torch.Generator().manual_seed(rows + 5 * chains)
    pss = [_block_params(gen, cuda)[1] for _ in range(chains)]
    attns = [torch.randn(rows, BLOCK_EMBED, generator=gen).to(cuda) for _ in range(chains)]
    hs = [torch.randn(rows, BLOCK_EMBED, generator=gen).to(cuda, torch.bfloat16).float() for _ in range(chains)]
    _check_post_fwd(attns, hs, pss, "gelu")


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "gelu", "identity"])
def test_block_post_forward_every_activation(cuda, activation):
    gen = torch.Generator().manual_seed(len(activation))
    pss = [_block_params(gen, cuda)[1] for _ in range(2)]
    attns = [torch.randn(1000, BLOCK_EMBED, generator=gen).to(cuda) for _ in range(2)]
    hs = [torch.randn(1000, BLOCK_EMBED, generator=gen).to(cuda, torch.bfloat16).float() for _ in range(2)]
    _check_post_fwd(attns, hs, pss, activation)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("embed", [16, 128])
@pytest.mark.parametrize("in_dim", [16, 48, 512])
def test_block_pre_forward_at_the_width_limits(cuda, in_dim, embed, x_dtype):
    """Input widths 16 to 512 (512: more images than the ring holds, so they
    stream) and embeddings 16 and 128, one and two chains."""
    gen = torch.Generator().manual_seed(in_dim + embed)
    for chains in (1, 2):
        pss = [_block_params_at(gen, cuda, in_dim, embed, 64)[0] for _ in range(chains)]
        xs = [torch.tanh(torch.randn(1000, in_dim, generator=gen)).to(cuda, x_dtype) for _ in range(chains)]
        _check_pre_fwd(xs, pss)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("embed", [16, 128])
@pytest.mark.parametrize("ff", [16, 48, 512])
def test_block_post_forward_at_the_width_limits(cuda, ff, embed, activation):
    """FFN widths 16 to 512 and embeddings 16 and 128 (the small ones keep
    their images resident), one and two chains, saving and primal."""
    gen = torch.Generator().manual_seed(ff + embed + len(activation))
    for chains in (1, 2):
        pss = [_block_params_at(gen, cuda, 48, embed, ff)[1] for _ in range(chains)]
        attns = [torch.randn(1000, embed, generator=gen).to(cuda) for _ in range(chains)]
        hs = [torch.randn(1000, embed, generator=gen).to(cuda, torch.bfloat16).float() for _ in range(chains)]
        _check_post_fwd(attns, hs, pss, activation)


def test_block_forward_plan_matches_the_python_mirror(cuda):
    """``fbf::plan`` against ``fwd_stages`` and ``fwd_grid``: the images the
    wrapper allocates and the grid the schedule assumes."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for op, in_dim, embed, ff in (("pre", 48, 128, 512), ("pre", 512, 16, 16), ("post", 48, 128, 512),
                                  ("post", 48, 16, 48)):
        for rows, chains in ((1, 1), (6144, 1), (6144, 2), (65536 + 37, 1)):
            plan = fb.fwd_plan(op, rows, chains, in_dim, embed, ff)
            assert plan["images"] == len(fb.fwd_stages(op, in_dim, embed, ff))
            assert (plan["blocks"], plan["tiles"]) == fb.fwd_grid(op, rows, chains, sms)
            per_sm = fb.FWD_GRID[op][1]
            assert plan["sms"] == sms and per_sm * (plan["smem_bytes"] + 1024) <= 233472
            assert plan["resident"] == (plan["slots"] == plan["images"])
    assert fb.fwd_plan("pre", 6144, 1, 48, 128, 512)["resident"] == 1  # the zoo's pre images stay
    assert fb.fwd_plan("post", 6144, 1, 48, 128, 512)["resident"] == 0  # the zoo's post images stream


def test_block_forwards_repeat_bitwise(cuda):
    """Two calls of each forward on the same inputs give the same bits."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(41)
    for chains in (1, 2):
        layers = [_block_params(gen, cuda) for _ in range(chains)]
        xs = [torch.tanh(torch.randn(6144 + 17, BLOCK_IN, generator=gen)).to(cuda) for _ in range(chains)]
        attns = [torch.randn(6144 + 17, BLOCK_EMBED, generator=gen).to(cuda) for _ in range(chains)]
        runs = []
        for _ in range(2):
            hs, qkvs = fb._launch_pre_fwd(xs, [l[0] for l in layers], fb._counter("pre_f", chains))
            outs = fb._launch_post_fwd(attns, hs, [l[1] for l in layers], "gelu", True, fb._counter("post_f", chains))
            runs.append([*hs, *qkvs, *(t for ts in outs for t in ts)])
        assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_block_forwards_follow_weights_changed_in_place(cuda):
    """Weights updated in place between two calls (as the optimizer does):
    the second call packs them afresh and gives the plain result for the new
    weights."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(43)
    pre, post = _block_params(gen, cuda)
    x = torch.tanh(torch.randn(6144, BLOCK_IN, generator=gen)).to(cuda)
    attn = torch.randn(6144, BLOCK_EMBED, generator=gen).to(cuda)
    h0, qkv0 = fb._launch_pre_fwd([x], [pre], "K4pre_f")
    out0 = fb._launch_post_fwd([attn], h0, [post], "gelu", False, "K4post_f")[0][0]
    for t in (*pre, *post):
        t.add_(0.05 * torch.randn(t.shape, generator=gen).to(cuda))
    (h1,), (qkv1,) = _check_pre_fwd([x], [pre])
    out1 = fb._launch_post_fwd([attn], [h1], [post], "gelu", False, "K4post_f")[0][0]
    _close(out1, fb.post_fwd_plain(attn, h1, *post, "gelu", False)[0], grad=False)
    assert not torch.equal(qkv0[0], qkv1) and not torch.equal(out0, out1)


@pytest.mark.parametrize("pair", [False, True])
def test_block_autograd_matches_cpu_and_carries_gh_in_fp32(cuda, pair):
    """pre -> post under autograd on the card against the same on the CPU
    (the plain versions): outputs, every parameter's gradient, and the
    residual's cotangent reaching the pre op in fp32."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(21 + pair)
    chains = 2 if pair else 1
    params = [p for _ in range(chains) for ps in _block_params(gen, "cpu") for p in ps]
    xs = [torch.tanh(torch.randn(6144, BLOCK_IN, generator=gen)) for _ in range(chains)]
    attn_noise = [torch.randn(6144, BLOCK_EMBED, generator=gen) for _ in range(chains)]
    gouts = [torch.randn(6144, BLOCK_EMBED, generator=gen) * 0.01 for _ in range(chains)]

    def run(device):
        ps = [p.detach().to(device).requires_grad_() for p in params]
        pre = [ps[18 * c:18 * c + 10] for c in range(chains)]
        post = [ps[18 * c + 10:18 * c + 18] for c in range(chains)]
        x = [t.to(device) for t in xs]
        fb.reset_launch_counts()
        if pair:
            ha, hc, qa, qc = fb.fused_block_pair_pre(*x, pre[0], pre[1])
            hs, qkvs = [ha, hc], [qa, qc]
        else:
            h, qkv = fb.fused_block_pre(x[0], *pre[0])
            hs, qkvs = [h], [qkv]
        seen = []
        for h in hs:
            h.register_hook(seen.append)
        attns = [q[:, :BLOCK_EMBED].float() * n.to(device) for q, n in zip(qkvs, attn_noise)]
        if pair:
            outs = list(fb.fused_block_pair_post(*attns, *hs, post[0], post[1]))
        else:
            outs = [fb.fused_block_post(attns[0], hs[0], *post[0])]
        torch.autograd.backward(outs, [g.to(device, torch.bfloat16) for g in gouts])
        return outs, ps, seen, dict(fb.LAUNCHES)

    outs, ps, seen, launches = run(cuda)
    ref_outs, ref_ps, _, _ = run("cpu")
    k = "K5" if pair else "K4"
    assert {n: v for n, v in launches.items() if v} == {f"{k}pre_f": 1, f"{k}pre_b": 1, f"{k}post_f": 1,
                                                          f"{k}post_b": 1}
    assert all(g.dtype == torch.float32 for g in seen) and len(seen) == chains
    assert any(not torch.equal(g, g.to(torch.bfloat16).float()) for g in seen)
    for a, b in zip(outs, ref_outs):
        _close(a.cpu(), b, grad=False)
    for a, b in zip(ps, ref_ps):
        _close(a.grad.cpu(), b.grad, grad=True)


def test_block_post_unsupported_activation_raises_on_cuda(cuda):
    """An activation the kernels do not take raises on CUDA tensors (the CPU
    takes the reference); nothing launches."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(27)
    post = _block_params(gen, cuda)[1]
    attn = torch.randn(64, BLOCK_EMBED, generator=gen).to(cuda)
    h = torch.randn(64, BLOCK_EMBED, generator=gen).to(cuda, torch.bfloat16).float()
    fb.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="silu"):
        fb.fused_block_post(attn, h, *post, "silu")
    with pytest.raises(NotImplementedError, match="silu"):
        fb.fused_block_pair_post(attn, attn, h, h, post, post, "silu")
    assert not any(fb.LAUNCHES.values())


def test_pair_tail_with_input_gradients_matches_plain(cuda):
    """K2f/K2b as the joint evaluation's MLP tails call them: 6,144 rows of
    128 -> 128 ELU with a trailing activation, input gradients flowing back."""
    gen = torch.Generator().manual_seed(33)
    widths = (128, 128)
    cpu = [_params(gen, "cpu", widths) for _ in range(2)]
    xs = [torch.randn(6144, 128, generator=gen).to(torch.bfloat16) for _ in range(2)]
    gs = [(torch.randn(6144, 128, generator=gen) * 0.01).to(torch.bfloat16) for _ in range(2)]

    def run(device):
        leaves = [[t.to(device).requires_grad_() for t in (*ws, *bs)] for ws, bs in cpu]
        x = [t.to(device).requires_grad_() for t in xs]
        fm.reset_launch_counts()
        outs = fm.fused_mlp_pair(*x, leaves[0][:1], leaves[0][1:], leaves[1][:1], leaves[1][1:], "elu", True,
                                 skip_input_grad=False)
        torch.autograd.backward(list(outs), [g.to(device) for g in gs])
        return outs, x, leaves, dict(fm.LAUNCHES)

    outs, x, leaves, launches = run(cuda)
    ref_outs, ref_x, ref_leaves, _ = run("cpu")
    assert launches["K2f"] == 1 and launches["K2b"] == 1
    for a, b in zip(outs, ref_outs):
        _close(a.cpu(), b, grad=False)
    for a, b in zip(x, ref_x):
        assert a.grad.dtype == torch.bfloat16
        _close(a.grad.cpu(), b.grad, grad=True)
    for la_, lb in zip(leaves, ref_leaves):
        for a, b in zip(la_, lb):
            _close(a.grad.cpu(), b.grad, grad=True)


# -- The recurrent entry's head (path R): 256 -> 128 ELU on the GRU's fp32 output --

R_WIDTHS = (256, 128)


@pytest.mark.parametrize("rows", [1024, 6144, 1000])
def test_recurrent_head_matches_plain_and_repeats_bitwise(cuda, rows):
    """K1f primal (the rollout step's 1,024 rows) and saving (the
    minibatch's 6,144, a ragged 1,000), and K1b with dX, on fp32 inputs
    as the GRU gives them; two backward calls give the same bits."""
    gen = torch.Generator().manual_seed(rows + 256)
    ws, bs = _params(gen, cuda, R_WIDTHS)
    x = torch.randn(rows, R_WIDTHS[0], generator=gen).to(cuda)
    for save in (False, True):
        (out,), _, _ = fm._launch_fwd([x], [ws], [bs], "elu", True, save, "K1f")
        ref, _ = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, save)
        _close(out, ref, grad=False)
    g = (torch.randn(rows, R_WIDTHS[1], generator=gen) * 0.01).to(cuda, torch.bfloat16)
    first = _check_chain_bwd([x], [g], [ws], [[ref]], "elu", True, False, "K1b")
    second = fm._launch_bwd([x], [g], [ws], [[ref]], "elu", True, False, "K1b")
    torch.cuda.synchronize()
    (dx, dws, dbs, _), (dx2, dws2, dbs2, _) = first[0], second[0]
    assert dx.dtype == torch.float32
    for a, b in zip((dx, *dws, *dbs), (dx2, *dws2, *dbs2)):
        assert torch.equal(a, b)


def test_recurrent_pair_heads_with_input_gradients_match_plain(cuda):
    """K2f/K2b as path RJ's joint evaluation calls them: the actor's and the
    critic's heads, 2 x 6,144 rows of 256 -> 128 ELU on the stacked GRUs'
    fp32 outputs, input gradients (fp32) flowing back into the cells."""
    gen = torch.Generator().manual_seed(34)
    cpu = [_params(gen, "cpu", R_WIDTHS) for _ in range(2)]
    xs = [torch.randn(6144, R_WIDTHS[0], generator=gen) for _ in range(2)]
    gs = [(torch.randn(6144, R_WIDTHS[1], generator=gen) * 0.01).to(torch.bfloat16) for _ in range(2)]

    def run(device):
        leaves = [[t.to(device).requires_grad_() for t in (*ws, *bs)] for ws, bs in cpu]
        x = [t.to(device).requires_grad_() for t in xs]
        fm.reset_launch_counts()
        outs = fm.fused_mlp_pair(*x, leaves[0][:1], leaves[0][1:], leaves[1][:1], leaves[1][1:], "elu", True,
                                 skip_input_grad=False)
        torch.autograd.backward(list(outs), [g.to(device) for g in gs])
        return outs, x, leaves, dict(fm.LAUNCHES)

    outs, x, leaves, launches = run(cuda)
    ref_outs, ref_x, ref_leaves, _ = run("cpu")
    assert launches["K2f"] == 1 and launches["K2b"] == 1
    for a, b in zip(outs, ref_outs):
        _close(a.cpu(), b, grad=False)
    for a, b in zip(x, ref_x):
        assert a.grad.dtype == torch.float32
        _close(a.grad.cpu(), b.grad, grad=True)
    for la_, lb in zip(leaves, ref_leaves):
        for a, b in zip(la_, lb):
            _close(a.grad.cpu(), b.grad, grad=True)


# -- K7f (banded window attention, T > 64) --------------------------------------


def _banded_inputs(gen, device, n, t_len, window, dim=32, heads=4, dtype=torch.bfloat16, invalid=False):
    """q/k/v in the JAX layout, segments with dones, a half-valid cache; with
    ``invalid`` a third of the environments see no valid key at all."""
    q, k, v, *masks = _lane_inputs(gen, device, n, heads=heads, t_len=t_len, window=window, dim=dim,
                                   invalid=invalid)
    return [t.to(dtype) for t in (q, k, v)] + masks


@pytest.mark.parametrize("n,t_len,window,dim,dtype,slopes", [
    (256, 256, 16, 32, torch.bfloat16, None),  # the long-rollout minibatch
    (1024, 256, 16, 32, torch.bfloat16, None),  # its value and KL passes
    (37, 200, 16, 32, torch.bfloat16, (0.5, 0.25, 0.125, 0.0625)),  # ragged T, ALiBi, rows with no key
    (5, 70, 160, 32, torch.bfloat16, None),  # W above the kernel's 128-query block
    (3, 129, 20, 64, torch.float32, (0.5, 0.25, 0.125, 0.0625)),
    (9, 65, 3, 8, torch.bfloat16, None),
    (2, 1, 5, 16, torch.float32, None),  # one query
])
def test_banded_kernel_matches_plain(cuda, n, t_len, window, dim, dtype, slopes):
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    gen = torch.Generator().manual_seed(n + t_len + window)
    q, k, v, *masks = _banded_inputs(gen, cuda, n, t_len, window, dim, dtype=dtype, invalid=slopes is not None)
    out = ba._launch_fwd(q, k, v, *masks, window, slopes)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, ba.banded_plain(q, k, v, *masks, window, slopes), **ATT_TOL)
    if slopes is not None:
        assert not out[: n // 3].any()  # rows without a valid key are exactly 0


def test_banded_autograd_wrapper_matches_plain_and_counts(cuda):
    """One K7f launch per call, none in the backward (it recomputes through
    the plain version, as the JAX package's custom VJP)."""
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    gen = torch.Generator().manual_seed(11)
    q, k, v, *masks = _banded_inputs(gen, cuda, 256, 256, 16)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ba.reset_launch_counts()
    out = ba.banded_window_attention(*leaves, *masks, window=16)
    out.backward(g)
    with torch.no_grad():
        primal = ba.banded_window_attention(q, k, v, *masks, window=16)
    torch.cuda.synchronize()
    assert ba.LAUNCHES == {"K7f": 2}
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = ba.banded_plain(*plain, *masks, 16)
    ref.backward(g)
    torch.testing.assert_close(out, ref, **ATT_TOL)
    torch.testing.assert_close(primal, out.detach(), rtol=0, atol=0)
    for a, b in zip(leaves, plain):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=1e-2, atol=1e-2)


# -- K9m (the fused PPO step, mono) ---------------------------------------------


def _ppo_rows(gen, device, rows, mean):
    std = torch.exp(torch.randn(A_DIM, generator=gen) * 0.2).to(device)
    action = mean + std * torch.randn(rows, A_DIM, generator=gen).to(device)
    old_logp = (-0.5 * ((action - mean) / std).square() - torch.log(std) - 0.9189385332046727).sum(-1)
    old_logp = old_logp + (torch.randn(rows, generator=gen) * 0.2).to(device)
    return std, (action, old_logp, torch.randn(rows, generator=gen).to(device),
                 torch.randn(rows, 1, generator=gen).to(device), torch.randn(rows, 1, generator=gen).to(device))


@pytest.mark.parametrize("rows", [24576, 1000])
@pytest.mark.parametrize("loss_clip", [None, 0.2])
def test_mono_kernel_matches_plain_and_split(cuda, rows, loss_clip):
    """K9m's forward (the activations it writes) against the plain forward
    (bf16, one rounding); its loss and backward against the plain loss
    backward on those activations at K9s's limits (a row at a clip bound may
    take the other branch: 3e-2 of the largest value; the loss sums 1e-4);
    and all of it against K2f + K9s, which run the same per-tile code."""
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(rows + 13)
    (wa, ba), (wc, bc) = _params(gen, cuda), _params(gen, cuda)
    (wm, bm), (wv, bv) = _heads(gen, cuda)
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(cuda) for _ in range(2)]
    with torch.no_grad():
        mean = fm.mlp_chain_fwd_plain(xs[0], wa, ba, "elu", True, False)[0].float() @ wm.T + bm
    std, rows_data = _ppo_rows(gen, cuda, rows, mean)
    tail = (wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, loss_clip, "elu", True)
    before = dict(fm.LAUNCHES)
    got, sums, saved = fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)
    assert fm.LAUNCHES["K9m"] == before["K9m"] + 1 and fm.LAUNCHES["K2f"] == before["K2f"]
    for x, ws, bs, hs in zip(xs, (wa, wc), (ba, bc), saved):
        out, hidden = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
        for h, r in zip(hs, [*hidden, out]):
            _close(h, r, grad=False)
    want, ref_sums = fp.ppo_loss_bwd_plain(xs, saved, [wa, wc], *tail)
    outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f")
    split, split_sums = fp._loss_bwd(xs, [[*h, o] for h, o in zip(hids, outs)], [wa, wc], *tail)
    torch.cuda.synchronize()
    flat = lambda g: [*g[0], *g[1], *g[2], *g[3], *g[4:]]
    for a, b, s in zip(flat(got), flat(want), flat(split)):
        a, b, s = a.float(), b.float(), s.float()
        assert torch.isfinite(a).all() and (a - b).abs().max() <= 3e-2 * b.abs().max()
        assert (a - s).abs().max() <= 3e-2 * s.abs().max()
    for ref in (ref_sums, split_sums):
        assert ((sums - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all(), (sums, ref)


def test_fused_ppo_step_mono_wrapper_matches_cpu_and_split(cuda, monkeypatch):
    """``fused_ppo_step`` with ``_PPO_MODE = "mono"``: one K9m launch and no
    K2f/K9s; the loss, its metrics and every ``.grad`` against the same call
    on the CPU (the plain version) and against split mode on the card."""
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(17)
    rows = 1000
    base = [*_params(gen, "cpu"), *_params(gen, "cpu")]
    heads = _heads(gen, "cpu")
    xa, xc = (torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)) for _ in range(2))
    with torch.no_grad():
        mean = fm.mlp_chain_fwd_plain(xa, base[0], base[1], "elu", True, False)[0].float() @ heads[0][0].T + heads[0][1]
    std, rows_data = _ppo_rows(gen, "cpu", rows, mean)

    def run(device, mode):
        monkeypatch.setattr(fp, "_PPO_MODE", mode)
        leaf = lambda t: t.detach().to(device, copy=True).requires_grad_()
        chains = [[leaf(t) for t in ts] for ts in base]
        hs = [leaf(t) for h in heads for t in h]
        s = leaf(std)
        before = dict(fm.LAUNCHES)
        loss, metrics = fp.fused_ppo_step(xa.to(device), xc.to(device), *chains, *hs, s,
                                          *(t.to(device) for t in rows_data), 0.2, 1.0, 0.5)
        loss.backward()
        launched = {k: v - before[k] for k, v in fm.LAUNCHES.items() if v != before[k]}
        grads = [p.grad.cpu() for p in (*(t for ts in chains for t in ts), *hs, s)]
        return torch.stack([loss, *metrics]).detach().cpu(), grads, launched

    mono, mono_grads, launched = run(cuda, "mono")
    assert launched == {"K9m": 1}
    for values, grads, _ in (run("cpu", "mono"), run(cuda, "split")):
        assert ((mono - values).abs() <= 2e-3 * values.abs().clamp(min=1.0)).all(), (mono, values)
        for a, b in zip(mono_grads, grads):
            assert (a - b).abs().max() <= 3e-2 * b.abs().max()


# -- Phase 2 of every backward (csrc/dw_phase2.cuh) ---------------------------

def _phase2_cases(name, gen, device):
    """``(kernel_fn, plain_fn, grad_rel)`` of one backward at a row count
    with several row splits and a short last split: each fn returns a flat
    list of the gradients (and sums) it computes."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    def flat(results):
        if isinstance(results, torch.Tensor):
            return [results]
        return [t for r in (results or ()) for t in flat(r)]

    if name == "K1b":  # TL's ELU head 128 -> 128 with dX
        rows = 65_537
        ws, bs = _params(gen, device, (128, 128))
        x = torch.randn(rows, 128, generator=gen).to(device, torch.bfloat16)
        g = (torch.randn(rows, 128, generator=gen) * 0.01).to(device, torch.bfloat16)
        out, _ = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, False)
        return (lambda: flat(fm._launch_bwd([x], [g], [ws], [[out]], "elu", True, False, "K1b")[0][:3]),
                lambda: flat(fm.mlp_chain_bwd_plain(x, g, ws, [out], "elu", True, False)), 1e-2)
    rows = 24_577
    if name in ("K2b", "K8b", "K9s", "K9m"):
        (wa, ba), (wc, bc) = _params(gen, device), _params(gen, device)
        xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(device) for _ in range(2)]
        outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f")
        hss = [[*h, o] for h, o in zip(hids, outs)]
        if name == "K2b":
            gs = [(torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(2)]
            return (lambda: flat(r[:3] for r in fm._launch_bwd(xs, gs, [wa, wc], hss, "elu", True, True, "K2b")),
                    lambda: flat(fm.mlp_chain_bwd_plain(x, g, ws, hs, "elu", True, True)
                                 for x, g, ws, hs in zip(xs, gs, [wa, wc], hss)), 1e-2)
        heads = _heads(gen, device)
        if name == "K8b":
            gm = (torch.randn(rows, A_DIM, generator=gen) * 0.01).to(device)
            gv = (torch.randn(rows, 1, generator=gen) * 0.01).to(device)
            spec = [(heads[0][0], None, gm, None), (heads[1][0], None, gv, None)]

            def plain():
                res = []
                for c in range(2):
                    d, dwh, dbh = fm.head_bwd_plain(hss[c][-1], spec[c][2], spec[c][0])
                    res += [*fm.mlp_chain_bwd_plain(xs[c], d, [wa, wc][c], hss[c], "elu", True, True)[1:], dwh, dbh]
                return flat(res)

            return (lambda: flat([*r[1:3], *r[3]] for r in fm._launch_bwd(xs, None, [wa, wc], hss, "elu", True, True,
                                                                          "K8b", heads=spec)), plain, 1e-2)
        (wm, bm), (wv, bv) = heads
        std = torch.exp(torch.randn(A_DIM, generator=gen) * 0.2).to(device)
        with torch.no_grad():
            mean = hss[0][-1].float() @ wm.T + bm
        action = mean + std * torch.randn(rows, A_DIM, generator=gen).to(device)
        old_logp = (-0.5 * ((action - mean) / std).square() - torch.log(std) - 0.9189385332046727).sum(-1)
        old_logp = old_logp + (torch.randn(rows, generator=gen) * 0.2).to(device)
        adv = torch.randn(rows, generator=gen).to(device)
        ret, old_value = torch.randn(rows, 1, generator=gen).to(device), torch.randn(rows, 1, generator=gen).to(device)
        tail = (wm, bm, wv, bv, std, action, old_logp, adv, old_value, ret, 0.2, 1.0, 0.5, None, "elu", True)
        if name == "K9s":
            return (lambda: flat(fp._loss_bwd(xs, hss, [wa, wc], *tail)),
                    lambda: flat(fp.ppo_loss_bwd_plain(xs, hss, [wa, wc], *tail)), 3e-2)
        saved = fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)[2]  # the mono kernel's activations, for the plain side
        return (lambda: flat(fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)[:2]),
                lambda: flat(fp.ppo_loss_bwd_plain(xs, saved, [wa, wc], *tail)), 3e-2)
    chains = 2 if name.startswith("K5") else 1
    rows = 65_537 if chains == 1 else 24_577
    layers = [_block_params(gen, device) for _ in range(chains)]
    if name.endswith("pre_b"):
        pres = [l[0] for l in layers]
        xs = [torch.tanh(torch.randn(rows, 48, generator=gen)).to(device) for _ in range(chains)]
        hs = [fb.pre_fwd_plain(x, *ps)[0] for x, ps in zip(xs, pres)]
        ghs = [(torch.randn(rows, 128, generator=gen) * 0.01).to(device) for _ in range(chains)]
        gqkvs = [(torch.randn(rows, 384, generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
        return (lambda: flat(fb._launch_pre_bwd(xs, hs, ghs, gqkvs, pres, True, name)),
                lambda: flat(fb.pre_bwd_plain(x, h, gh, gq, ps[0], *ps[4:7], ps[2], ps[3], True)
                             for x, h, gh, gq, ps in zip(xs, hs, ghs, gqkvs, pres)), 1e-2)
    posts = [l[1] for l in layers]
    attns = [torch.randn(rows, 128, generator=gen).to(device) for _ in range(chains)]
    h_in = [torch.randn(rows, 128, generator=gen).to(device, torch.bfloat16).float() for _ in range(chains)]
    prefs = [fb.post_fwd_plain(a, h, *ps, "gelu", True) for a, h, ps in zip(attns, h_in, posts)]
    gs = [(torch.randn(rows, 128, generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
    wss = [(ps[0], ps[4], ps[6], ps[2], ps[3]) for ps in posts]
    return (lambda: flat(fb._launch_post_bwd(attns, gs, [r[1] for r in prefs], [r[2] for r in prefs], wss, "gelu",
                                             name)),
            lambda: flat(fb.post_bwd_plain(a, g, r[1], r[2], *ws, "gelu")
                         for a, g, r, ws in zip(attns, gs, prefs, wss)), 1e-2)


@pytest.mark.parametrize("name", ["K1b", "K2b", "K8b", "K9s", "K9m", "K4pre_b", "K4post_b", "K5pre_b", "K5post_b"])
def test_backward_phase2_split_rows_match_plain_and_repeat_bitwise(cuda, name):
    """Every backward at a row count that phase 2 splits into several row
    ranges in clusters (65,537 or 24,577 rows; at 65,537 and for K5 several
    clusters a tile, whose partials meet in the scratch): each gradient and
    sum against the plain version at the usual limits (3e-2 for the PPO
    step's, a row at a clip bound), and a second call gives the same bits."""
    from cusrl_tpu_torch.nn.kernels import dw_phase2

    mlp_tiles = dw_phase2.dw_tile_count([(512, 48), (256, 512), (128, 256)], [dw_phase2.H_F32])
    assert dw_phase2.dw_row_splits(-(-24_577 // 64), mlp_tiles, 2) == (6, 2)  # 3 clusters a tile
    assert dw_phase2.dw_row_splits(-(-65_537 // 64), 1, 1) == (120, 8)  # K1b: 15 clusters
    gen = torch.Generator().manual_seed(len(name) + 6)
    kernel, plain, rel = _phase2_cases(name, gen, cuda)
    first, second, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    assert len(first) == len(want)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all() and (a - w).abs().max() <= rel * w.abs().max()


def test_wide_head_fused_update_step_on_card_matches_cpu(cuda):
    """``FusedPpoUpdate`` with a 65-wide action head: the chains run K2f/K2b
    on the card (one launch each, no K9s) and the heads and loss outside;
    its objective and every gradient against the same step on the CPU
    (``ppo_step_reference``), at the head wrappers' limits."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    factory.fused_ppo_update = True
    agents = {d: factory(VelocityLocomotionEnv(num_instances=8, observation_dim=48, action_dim=65, device=d).spec,
                         device=d) for d in ("cpu", "cuda")}
    agents["cuda"].model.load_state_dict(agents["cpu"].model.state_dict())
    gen = torch.Generator().manual_seed(65)
    rows = 2048
    obs = torch.tanh(torch.randn(rows, 48, generator=gen))
    with torch.no_grad():
        dist, _, _ = agents["cpu"].actor(obs)
        action = dist["mean"] + dist["std"] * torch.randn(rows, 65, generator=gen)
        logp = agents["cpu"].actor.compute_logp(dist, action)
    batch = {"observation": obs, "action": action, "action_logp": logp + 0.1 * torch.randn(logp.shape, generator=gen),
             "advantage": torch.randn(rows, 1, generator=gen), "return": torch.randn(rows, 1, generator=gen),
             "value": torch.randn(rows, 1, generator=gen)}
    results = {}
    for device, agent in agents.items():
        hook = agent.get_hook("fused_ppo_update")
        assert not hook.fuse_heads
        fm.reset_launch_counts()
        objectives, metrics = hook.objective(agent, None, {k: v.to(device) for k, v in batch.items()})
        sum(objectives.values()).backward()
        launched = {k: v for k, v in fm.LAUNCHES.items() if v}
        assert launched == ({"K2f": 1, "K2b": 1} if device == "cuda" else {}), launched
        results[device] = ({k: v.item() for k, v in {**objectives, **metrics}.items()},
                           {p: t.grad.cpu() for p, t in agent.model.named_parameters()})
    (values, grads), (ref_values, ref_grads) = results["cuda"], results["cpu"]
    for key, ref in ref_values.items():
        assert abs(values[key] - ref) <= 2e-3 * max(1.0, abs(ref)), key
    for path, ref in ref_grads.items():
        assert (grads[path] - ref).abs().max() <= 3e-2 * ref.abs().max(), path


def _at_offset(t):
    """``t``'s values in a contiguous view that starts one element past an
    aligned address."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def test_backward_takes_contiguous_inputs_at_unaligned_offsets(cuda):
    """Phase 2 reads its operands with 16-byte loads; the wrappers copy a
    contiguous input that starts elsewhere (K1b's x and saved output, K4
    pre b's x and qkv cotangent, K4 post b's attention output, cotangent
    and saved activations), so such a view gives the same bits."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    def flat(results):
        if isinstance(results, torch.Tensor):
            return [results]
        return [t for r in (results or ()) for t in flat(r)]

    def same(a, b):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    gen = torch.Generator().manual_seed(16)
    rows = 1000
    ws, bs = _params(gen, cuda, (128, 128))
    x = torch.randn(rows, 128, generator=gen).to(cuda, torch.bfloat16)
    g = (torch.randn(rows, 128, generator=gen) * 0.01).to(cuda, torch.bfloat16)
    out, _ = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, False)
    same(flat(fm._launch_bwd([_at_offset(x)], [_at_offset(g)], [ws], [[_at_offset(out)]], "elu", True, False,
                             "K1b")[0][:3]),
         flat(fm._launch_bwd([x], [g], [ws], [[out]], "elu", True, False, "K1b")[0][:3]))
    pre, post = _block_params(gen, cuda)
    x = torch.tanh(torch.randn(rows, 48, generator=gen)).to(cuda)
    h = fb.pre_fwd_plain(x, *pre)[0]
    gh = (torch.randn(rows, 128, generator=gen) * 0.01).to(cuda)
    gqkv = (torch.randn(rows, 384, generator=gen) * 0.01).to(cuda, torch.bfloat16)
    same(flat(fb._launch_pre_bwd([_at_offset(x)], [h], [gh], [_at_offset(gqkv)], [pre], True, "K4pre_b")),
         flat(fb._launch_pre_bwd([x], [h], [gh], [gqkv], [pre], True, "K4pre_b")))
    attn = torch.randn(rows, 128, generator=gen).to(cuda)
    _, r1, saved = fb.post_fwd_plain(attn, h, *post, "gelu", True)
    g = (torch.randn(rows, 128, generator=gen) * 0.01).to(cuda, torch.bfloat16)
    wts = (post[0], post[4], post[6], post[2], post[3])
    same(flat(fb._launch_post_bwd([_at_offset(attn)], [_at_offset(g)], [r1], [_at_offset(saved)], [wts], "gelu",
                                  "K4post_b")),
         flat(fb._launch_post_bwd([attn], [g], [r1], [saved], [wts], "gelu", "K4post_b")))


# -- Phase 1 of the backwards on wgmma: the chain (K1b, K2b, K8b, K9s) and the
# -- fused block's post backward (K4/K5 post b) at every shape they take ------


def _check_chain_bwd(xs, gs, wss, hss, activation, trailing, skip, counter, heads=None):
    """Each chain of one backward launch against the plain version; returns
    the launch's results."""
    got = fm._launch_bwd(xs, gs, wss, hss, activation, trailing, skip, counter, heads=heads)
    for c, (dx, dws, dbs, head_grads) in enumerate(got):
        g = gs[c] if heads is None else None
        want_head = ()
        if heads is not None:
            w, _, gh, gl = heads[c]
            g, rdwh, rdbh = fm.head_bwd_plain(hss[c][-1], gh, w, gl)
            want_head = (rdwh, rdbh)
        rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], g, wss[c], hss[c], activation, trailing, skip)
        for a, b in zip([*dws, *dbs, *(head_grads or ())], [*rdws, *rdbs, *want_head]):
            _close(a, b, grad=True)
        assert (dx is None) == skip
        if not skip:
            _close(dx, rdx, grad=True)
    return got


def _chain_inputs(gen, device, widths, rows, chains, activation="elu", trailing=True):
    """Weights, inputs, bf16 cotangents and the plain forward's saved values."""
    params = [_params(gen, device, widths) for _ in range(chains)]
    wss = [p[0] for p in params]
    xs = [torch.tanh(torch.randn(rows, widths[0], generator=gen)).to(device) for _ in range(chains)]
    gs = [(torch.randn(rows, widths[-1], generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
    hss = []
    for x, (ws, bs) in zip(xs, params):
        out, hiddens = fm.mlp_chain_fwd_plain(x, ws, bs, activation, trailing, True)
        hss.append([*hiddens, out])
    return xs, gs, wss, hss


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 1024, 65573])
def test_chain_backward_at_ragged_rows(cuda, rows, chains):
    """Rows that end inside a 64-row tile give 0 there and are not stored;
    with and without dX (K1b, K2b)."""
    gen = torch.Generator().manual_seed(rows + 11 * chains)
    xs, gs, wss, hss = _chain_inputs(gen, cuda, WIDTHS, rows, chains)
    for skip in (False, True):
        _check_chain_bwd(xs, gs, wss, hss, "elu", True, skip, "K1b" if chains == 1 else "K2b")


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "gelu", "identity"])
def test_chain_backward_every_activation(cuda, activation):
    """Each activation (gelu's derivative from the saved pre-activation) at
    the main path's widths (streamed images) and the transformer head's
    128 -> 128 (resident), with and without the trailing activation."""
    gen = torch.Generator().manual_seed(3 * len(activation))
    for widths in (WIDTHS, (128, 128), (128, 512, 128)):
        for trailing in ((False,) if activation == "gelu" else (True, False)):
            xs, gs, wss, hss = _chain_inputs(gen, cuda, widths, 1000, 1, activation, trailing)
            for skip in (False, True):
                _check_chain_bwd(xs, gs, wss, hss, activation, trailing, skip, "K1b")


@pytest.mark.parametrize("widths", [(16, 16), (48, 80, 48), (512, 512), (16, 512, 16), (80, 16, 512), (128, 128),
                                    (512, 16), EIGHT_LAYERS])
def test_chain_backward_at_the_width_limits(cuda, widths):
    """Widths 16 to 512, 1 to 8 layers, one and two chains, with and
    without dX and the trailing activation."""
    gen = torch.Generator().manual_seed(sum(widths) + 1)
    for chains in (1, 2):
        for trailing in (True, False):
            xs, gs, wss, hss = _chain_inputs(gen, cuda, widths, 1000, chains, "tanh", trailing)
            for skip in (False, True):
                _check_chain_bwd(xs, gs, wss, hss, "tanh", trailing, skip, "K1b" if chains == 1 else "K2b")


@pytest.mark.parametrize("rows", [1024, 1000])
@pytest.mark.parametrize("head_dim", [1, 12, 64])
def test_pair_heads_backward_at_head_widths(cuda, head_dim, rows):
    """K8b's fp32 head backward 1 to 64 outputs wide, its top d in the
    accumulators' layout, with the latent's own cotangent on the actor."""
    gen = torch.Generator().manual_seed(7 * head_dim + rows)
    xs, _, wss, hss = _chain_inputs(gen, cuda, WIDTHS, rows, 2)
    gl = (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(cuda)
    spec = [((torch.randn(head_dim, WIDTHS[-1], generator=gen) * 0.2).to(cuda), None,
             (torch.randn(rows, head_dim, generator=gen) * 0.01).to(cuda), latent) for latent in (gl, None)]
    for skip in (True, False):
        _check_chain_bwd(xs, None, wss, hss, "elu", True, skip, "K8b", heads=spec)


def _post_bwd_case(gen, device, rows, chains, embed, ff, activation):
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    pss = [_block_params_at(gen, device, 16, embed, ff)[1] for _ in range(chains)]
    attns = [torch.randn(rows, embed, generator=gen).to(device) for _ in range(chains)]
    hs = [torch.randn(rows, embed, generator=gen).to(device, torch.bfloat16).float() for _ in range(chains)]
    refs = [fb.post_fwd_plain(a, h, *ps, activation, True) for a, h, ps in zip(attns, hs, pss)]
    gs = [(torch.randn(rows, embed, generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
    wss = [(ps[0], ps[4], ps[6], ps[2], ps[3]) for ps in pss]
    return attns, gs, [r[1] for r in refs], [r[2] for r in refs], wss


def _check_post_bwd(case, activation):
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    attns, gs, r1s, saveds, wss = case
    got = fb._launch_post_bwd(attns, gs, r1s, saveds, wss, activation, fb._counter("post_b", len(attns)))
    for c, result in enumerate(got):
        want = fb.post_bwd_plain(attns[c], gs[c], r1s[c], saveds[c], *wss[c], activation)
        for a, b in zip(result, want):
            _close(a, b, grad=True)
    return got


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("embed", [16, 128])
@pytest.mark.parametrize("ff", [16, 48, 512])
def test_block_post_backward_at_the_width_limits(cuda, ff, embed, chains):
    """The post backward's phase 1 at embed 16 and 128 and FFN widths 16,
    48 and 512 (resident and streamed images, a chunk narrower than 64),
    one and two chains, gelu and relu."""
    gen = torch.Generator().manual_seed(ff + embed + chains)
    for activation in ("gelu", "relu"):
        _check_post_bwd(_post_bwd_case(gen, cuda, 1000, chains, embed, ff, activation), activation)


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 1024, 65573])
def test_block_post_backward_at_ragged_rows(cuda, rows, chains):
    gen = torch.Generator().manual_seed(rows + 5 * chains)
    _check_post_bwd(_post_bwd_case(gen, cuda, rows, chains, BLOCK_EMBED, BLOCK_FF, "gelu"), "gelu")


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "gelu", "identity"])
def test_block_post_backward_every_activation(cuda, activation):
    gen = torch.Generator().manual_seed(len(activation) + 1)
    _check_post_bwd(_post_bwd_case(gen, cuda, 6144 + 17, 1, BLOCK_EMBED, BLOCK_FF, activation), activation)


def test_redesigned_backwards_repeat_bitwise(cuda):
    """Two calls of K1b (streamed and resident images), K2b, K8b, K9s and
    the post backward (K4, K5) on the same inputs give the same bits: the
    column sums take a fixed order."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(61)
    rows = 24576 + 17
    xs, gs, wss, hss = _chain_inputs(gen, cuda, WIDTHS, rows, 2)
    xh, gh, wh, hh = _chain_inputs(gen, cuda, (128, 128), 65536 + 5, 1)
    heads = [(w, None, (torch.randn(rows, w.shape[0], generator=gen) * 0.01).to(cuda), None)
             for w, _ in _heads(gen, cuda)]
    (wm, bm), (wv, bv) = _heads(gen, cuda)
    std = torch.exp(torch.randn(A_DIM, generator=gen) * 0.2).to(cuda)
    action = torch.randn(rows, A_DIM, generator=gen).to(cuda)
    loss_args = (xs, hss, wss, wm, bm, wv, bv, std, action, torch.randn(rows, generator=gen).to(cuda) - 12.0,
                 torch.randn(rows, generator=gen).to(cuda), torch.randn(rows, 1, generator=gen).to(cuda),
                 torch.randn(rows, 1, generator=gen).to(cuda), 0.2, 1.0, 0.5, 0.2, "elu", True)
    post = [_post_bwd_case(gen, cuda, 65536 + 37, chains, BLOCK_EMBED, BLOCK_FF, "gelu") for chains in (1, 2)]
    calls = [lambda: fm._launch_bwd(xs[:1], gs[:1], wss[:1], hss[:1], "elu", True, False, "K1b"),
             lambda: fm._launch_bwd(xh, gh, wh, hh, "elu", True, False, "K1b"),
             lambda: fm._launch_bwd(xs, gs, wss, hss, "elu", True, True, "K2b"),
             lambda: fm._launch_bwd(xs, None, wss, hss, "elu", True, True, "K8b", heads=heads),
             lambda: fp._loss_bwd(*loss_args),
             *(lambda case=case: fb._launch_post_bwd(*case, "gelu", fb._counter("post_b", len(case[0])))
               for case in post)]
    for call in calls:
        first, second = _flat(call()), _flat(call())
        assert first and len(first) == len(second)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_redesigned_backwards_follow_weights_changed_in_place(cuda):
    """Weights updated in place between two calls (as the optimizer does):
    the second call packs or converts their transposed images afresh."""
    gen = torch.Generator().manual_seed(67)
    for widths in (WIDTHS, (128, 128)):
        xs, gs, wss, hss = _chain_inputs(gen, cuda, widths, 6144, 1)
        first = _check_chain_bwd(xs, gs, wss, hss, "elu", True, False, "K1b")[0][0].clone()
        for w in wss[0]:
            w.add_(0.05 * torch.randn(w.shape, generator=gen).to(cuda))
        second = _check_chain_bwd(xs, gs, wss, hss, "elu", True, False, "K1b")[0][0]
        assert not torch.equal(first, second)
    case = _post_bwd_case(gen, cuda, 6144, 1, BLOCK_EMBED, BLOCK_FF, "gelu")
    first = _check_post_bwd(case, "gelu")[0][0].clone()
    for w in case[4][0][:3]:
        w.add_(0.05 * torch.randn(w.shape, generator=gen).to(cuda))
    assert not torch.equal(first, _check_post_bwd(case, "gelu")[0][0])


def test_backward_plans_match_the_python_mirrors(cuda):
    """``mlpb::plan`` against ``weight_images.chain_bwd_plan`` and
    ``fbb::plan`` against ``fused_block.post_bwd_plan`` (the images the
    wrappers allocate, the grid the schedule assumes), within the card's
    shared memory."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import weight_images as wi

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for widths in (WIDTHS, (128, 512, 128), (128, 128), (16, 16), (512, 16), EIGHT_LAYERS):
        for rows, chains in ((1, 1), (1024, 2), (24576, 2), (65573, 1)):
            for skip in (False, True):
                for head_mode, head_dim in ((0, 0), (1, 12), (2, 12), (1, 64)):
                    plan = fm.bwd_plan(widths, rows, chains, skip, head_mode, head_dim)
                    assert plan == wi.chain_bwd_plan(tuple(widths), rows, chains, sms, skip, head_mode, head_dim)
                    assert plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    for embed, ff in ((128, 512), (16, 16), (128, 48), (16, 512)):
        for rows, chains in ((1, 1), (6144, 2), (65573, 1)):
            assert fb.bwd_plan(rows, chains, embed, ff) == fb.post_bwd_plan(rows, chains, embed, ff, sms)


# -- the pre backward's phase 1 on wgmma (fbp::) ---------------------------------


def _pre_bwd_case(gen, device, rows, chains, in_dim, embed, x_dtype=torch.float32, with_gh=True):
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    pss = [_block_params_at(gen, device, in_dim, embed, 16)[0] for _ in range(chains)]
    xs = [torch.tanh(torch.randn(rows, in_dim, generator=gen)).to(device, x_dtype) for _ in range(chains)]
    hs = [fb.pre_fwd_plain(x, *ps)[0] for x, ps in zip(xs, pss)]
    ghs = [(torch.randn(rows, embed, generator=gen) * 0.01).to(device) if with_gh else None for _ in range(chains)]
    gqkvs = [(torch.randn(rows, 3 * embed, generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
    return xs, hs, ghs, gqkvs, pss


def _check_pre_bwd(case, skip):
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    xs, hs, ghs, gqkvs, pss = case
    got = fb._launch_pre_bwd(xs, hs, ghs, gqkvs, pss, skip, fb._counter("pre_b", len(xs)))
    for c, result in enumerate(got):
        ps = pss[c]
        want = fb.pre_bwd_plain(xs[c], hs[c], ghs[c], gqkvs[c], ps[0], *ps[4:7], ps[2], ps[3], skip)
        assert (result[0] is None) == skip
        for a, b in zip(result, want):
            if b is not None:
                _close(a, b, grad=True)
    return got


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 6144 + 17, 65536 + 37])
def test_block_pre_backward_at_ragged_rows(cuda, rows, chains):
    """The pre backward's phase 1 (resident qkv images) at row counts that
    end inside a 64-row tile, one and two chains, with and without dX."""
    gen = torch.Generator().manual_seed(rows + 11 * chains)
    case = _pre_bwd_case(gen, cuda, rows, chains, BLOCK_IN, BLOCK_EMBED)
    for skip in (True, False):
        _check_pre_bwd(case, skip)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("embed", [16, 128])
@pytest.mark.parametrize("in_dim", [16, 48, 512])
def test_block_pre_backward_at_the_width_limits(cuda, in_dim, embed, chains, x_dtype):
    """Input widths 16, 48 and 512 (dX in one to four 128-column chunks, its
    images streamed where they outgrow the ring), embeddings 16 (segments of
    16 columns padded to 64) and 128, x in fp32 and bf16; without gh in one
    chain."""
    gen = torch.Generator().manual_seed(in_dim + embed + chains)
    case = _pre_bwd_case(gen, cuda, 1000, chains, in_dim, embed, x_dtype, with_gh=chains == 1)
    for skip in (True, False):
        _check_pre_bwd(case, skip)


def test_pre_backward_repeats_bitwise_and_follows_weights_changed_in_place(cuda):
    """Two calls of K4 and K5 pre b on the same inputs give the same bits
    (the column sums take a fixed order); weights updated in place between
    calls are packed afresh."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(71)
    for chains in (1, 2):
        case = _pre_bwd_case(gen, cuda, 65536 + 37, chains, BLOCK_IN, BLOCK_EMBED)
        for skip in (True, False):
            call = lambda: fb._launch_pre_bwd(*case, skip, fb._counter("pre_b", chains))  # noqa: E731
            first, second = _flat(call()), _flat(call())
            assert first and len(first) == len(second)
            assert all(torch.equal(a, b) for a, b in zip(first, second))
    case = _pre_bwd_case(gen, cuda, 6144, 1, BLOCK_IN, BLOCK_EMBED)
    first = _check_pre_bwd(case, False)[0]
    before = [t.clone() for t in (first[0], first[5])]  # dx, dW_q
    for i in (0, 4, 5, 6):  # W_in, W_q, W_k, W_v
        case[4][0][i].add_(0.05 * torch.randn(case[4][0][i].shape, generator=gen).to(cuda))
    second = _check_pre_bwd(case, False)[0]
    assert not torch.equal(before[0], second[0]) and torch.equal(before[1], second[5])  # dW_q reads no weight


def test_pre_backward_plan_matches_the_python_mirror(cuda):
    """``fbp::plan`` against ``fused_block.pre_bwd_plan`` (the images the
    wrapper allocates, the grid the schedule assumes)."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for in_dim, embed in ((48, 128), (16, 16), (512, 128), (512, 16)):
        for rows, chains in ((1, 1), (6144, 2), (65573, 1)):
            for skip in (True, False):
                plan = fb.pre_bwd_card_plan(rows, chains, in_dim, embed, skip)
                assert plan == fb.pre_bwd_plan(rows, chains, in_dim, embed, skip, sms)


# -- K6 (next-token lane attention), redesigned ----------------------------------


def _next_inputs(gen, device, n, t_len, window, dim, dtype, heads=4):
    q, k, v, *masks = _lane_inputs(gen, device, n, heads=heads, t_len=t_len, window=window, dim=dim, invalid=True)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    k_self, v_self = (torch.randn(q.shape, generator=gen).to(device, dtype) for _ in range(2))
    return q, k_self, v_self, k, v, masks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [1, 24, 64, 128])
def test_next_token_kernel_matches_plain(cuda, t_len, dim, dtype):
    """K6 against ``next_token_plain`` at ragged N (37 environments), with
    and without ALiBi, a third of the environments with an all-masked band
    (the own key alone), W = 16 and W = 40 (three passes of the band); two
    calls give the same bits."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(t_len + dim)
    for window, slopes in ((16, None), (40, (0.5, 0.25, 0.125, 0.0625))):
        q, k_self, v_self, k, v, masks = _next_inputs(gen, cuda, 37, t_len, window, dim, dtype)
        out = la._launch_next(q, k_self, v_self, k, v, *masks, window, slopes)
        want = la.next_token_plain(q, k_self, v_self, k, v, *masks, window, slopes)
        torch.testing.assert_close(out, want, **ATT_TOL)
        torch.testing.assert_close(out[: 37 // 3], v_self[: 37 // 3].float(), **ATT_TOL)  # nothing but the own key
        assert torch.equal(out, la._launch_next(q, k_self, v_self, k, v, *masks, window, slopes))


def test_next_token_kernel_reads_the_main_paths_views(cuda):
    """The operands as the transformer hands them over (v_self a head-split
    view of the projection, q_seg a transposed view): no copy, and the same
    bits as on contiguous copies; one launch, counted."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(5)
    n, heads, t_len, window, dim = 1024, 4, 24, 16, 32
    q, k_self, _, k, v, (q_seg, k_seg, k_valid) = _next_inputs(gen, cuda, n, t_len, window, dim, torch.bfloat16)
    proj = torch.randn(n, t_len, 3 * heads * dim, generator=gen).to(cuda, torch.bfloat16)
    v_self = proj[..., 2 * heads * dim:].reshape(n, t_len, heads, dim).transpose(1, 2)
    q_seg_t = q_seg.T.contiguous().T
    la.reset_launch_counts()
    out = la.lane_next_token_attention(q, k_self, v_self, k, v, q_seg_t, k_seg, k_valid, window=window)
    assert la.LAUNCHES["K6"] == 1
    same = la._launch_next(q, k_self, v_self.contiguous(), k, v, q_seg, k_seg, k_valid, window, None)
    assert torch.equal(out, same)
    torch.testing.assert_close(out, la.next_token_plain(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, window),
                               **ATT_TOL)


def test_next_token_plan_matches_the_python_mirror(cuda):
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    for t_len in (1, 24, 128):
        for dim in (8, 32, 64):
            for dtype in (torch.bfloat16, torch.float32):
                for window in (0, 16, 100):
                    q = torch.empty(3, 4, t_len, dim, dtype=dtype, device=cuda)
                    assert la.next_card_plan(q, window) == la.next_plan(t_len, window, dim, dtype)


# -- K3f (lane window attention forward), redesigned -----------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [1, 5, 24, 128])
def test_lane_fwd_kernel_matches_plain(cuda, t_len, dim, dtype):
    """K3f, primal and saving the probabilities, against ``lane_fwd_plain``
    at a ragged N (37 environments: not a multiple of a block's problems),
    with and without ALiBi, a third of the environments with no valid key
    (exactly 0), W = 16 (the band's scores in one pass) and W = 40 (two
    passes); two calls give the same bits."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(t_len * 100 + dim)
    for window, slopes in ((16, None), (40, (0.5, 0.25, 0.125, 0.0625))):
        q, k, v, *masks = _lane_inputs(gen, cuda, 37, t_len=t_len, window=window, dim=dim, invalid=True)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        for save in (False, True):
            out, probs = la._launch_fwd(q, k, v, *masks, window, slopes, save)
            ref, ref_probs = la.lane_fwd_plain(q, k, v, *masks, window, slopes, save)
            torch.testing.assert_close(out, ref, **ATT_TOL)
            assert (probs is None) != save
            if save:
                torch.testing.assert_close(probs, ref_probs, **ATT_TOL)
                assert not probs[: 37 // 3].any()
            assert not out[: 37 // 3].any()
            again, again_probs = la._launch_fwd(q, k, v, *masks, window, slopes, save)
            assert torch.equal(out, again) and (not save or torch.equal(probs, again_probs))


def test_lane_fwd_kernel_reads_the_main_paths_views(cuda):
    """The operands as the transformer hands them over (q a head-split view
    of a projection, q_seg a transposed view): no copy, the same bits as on
    contiguous copies, one launch a call; at the update's N = 256 (saving)
    and the value pass's N = 1,024 (primal) against the plain version."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(8)
    heads, t_len, window, dim = 4, 24, 16, 32
    for n, save in ((256, True), (1024, False)):
        _, k, v, q_seg, k_seg, k_valid = _lane_inputs(gen, cuda, n)
        proj = torch.randn(n, t_len, 3 * heads * dim, generator=gen).to(cuda, torch.bfloat16)
        q = proj[..., :heads * dim].reshape(n, t_len, heads, dim).transpose(1, 2)
        q_seg_t = q_seg.T.contiguous().T
        p, keep = la._fwd_params(q, k, v, q_seg_t, k_seg, k_valid, window, None)
        assert (p.q, p.q_seg) == (q.data_ptr(), q_seg_t.data_ptr())
        la.reset_launch_counts()
        out, probs = la._launch_fwd(q, k, v, q_seg_t, k_seg, k_valid, window, None, save)
        assert la.LAUNCHES["K3f"] == 1
        same, same_probs = la._launch_fwd(q.contiguous(), k, v, q_seg, k_seg, k_valid, window, None, save)
        assert torch.equal(out, same) and (not save or torch.equal(probs, same_probs))
        ref, ref_probs = la.lane_fwd_plain(q, k, v, q_seg, k_seg, k_valid, window, None, save)
        torch.testing.assert_close(out, ref, **ATT_TOL)
        if save:
            torch.testing.assert_close(probs, ref_probs, **ATT_TOL)


def test_lane_fwd_plan_matches_the_python_mirror(cuda):
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    for t_len in (1, 24, 128):
        for dim in (8, 32, 64):
            for dtype in (torch.bfloat16, torch.float32):
                for window in (0, 16, 31, 32, 100):
                    q = torch.empty(3, 4, t_len, dim, dtype=dtype, device=cuda)
                    assert la.fwd_card_plan(q, window) == la.fwd_plan(t_len, window, dim, dtype)


# -- K3b (lane window attention backward), redesigned ----------------------------


def _bwd_case(gen, device, n, t_len, window, dim, dtype, slopes=None):
    """K3b's inputs: q/k/v in ``dtype``, the plain forward's probabilities
    (a third of the environments see no valid key: all their weights 0) and
    an fp32 cotangent."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    q, k, v, *masks = _lane_inputs(gen, device, n, t_len=t_len, window=window, dim=dim, invalid=True)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    _, probs = la.lane_fwd_plain(q, k, v, *masks, window, slopes, True)
    g = torch.randn(q.shape, generator=gen).to(device)
    return q, k, v, probs, g, masks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [1, 5, 24, 128])
def test_lane_bwd_kernel_matches_plain(cuda, t_len, dim, dtype):
    """K3b against ``lane_bwd_plain`` at a ragged N (37 environments: not a
    multiple of a block's problems), W = 16 (dw in one pass) and W = 40 with
    ALiBi (two passes), a third of the environments with no valid key (their
    dq, dk and dv exactly 0); the bf16 outputs are the fp32 ones cast, bit
    for bit; two calls give the same bits."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(t_len * 100 + dim + 7)
    for window, slopes in ((16, None), (40, (0.5, 0.25, 0.125, 0.0625))):
        q, k, v, probs, g, masks = _bwd_case(gen, cuda, 37, t_len, window, dim, dtype, slopes)
        got = la._launch_bwd(q, k, v, probs, g, *masks, window)
        for a, b in zip(got, la.lane_bwd_plain(q, k, v, probs, g, window)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            torch.testing.assert_close(a, b, **ATT_TOL)
            assert not a[: 37 // 3].any()
        rounded = la._launch_bwd(q, k, v, probs, g, *masks, window, torch.bfloat16)
        again = la._launch_bwd(q, k, v, probs, g, *masks, window)
        for a, b, c in zip(got, rounded, again):
            assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
            assert torch.equal(a, c)


def test_lane_bwd_kernel_reads_the_main_paths_views(cuda):
    """The operands as the transformer hands them over (q a head-split view
    of a projection, the cotangent the transposed view of the merged heads'
    gradient): no copy, the same bits as on contiguous copies, one launch a
    call, bf16 outputs as the autograd wrapper asks; at the update's
    N = 256 against the plain version."""
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(9)
    n, heads, t_len, window, dim = 256, 4, 24, 16, 32
    _, k, v, *masks = _lane_inputs(gen, cuda, n)
    proj = torch.randn(n, t_len, 3 * heads * dim, generator=gen).to(cuda, torch.bfloat16)
    q = proj[..., :heads * dim].reshape(n, t_len, heads, dim).transpose(1, 2)
    _, probs = la.lane_fwd_plain(q, k, v, *masks, window, None, True)
    g = torch.randn(t_len * n, heads * dim, generator=gen).to(cuda).view(t_len, n, heads, dim).permute(1, 2, 0, 3)
    p, keep = la._bwd_params(q, k, v, probs, g, *masks, window)
    assert (p.q, p.g) == (q.data_ptr(), g.data_ptr())
    la.reset_launch_counts()
    got = la._launch_bwd(q, k, v, probs, g, *masks, window, torch.bfloat16)
    assert la.LAUNCHES["K3b"] == 1
    same = la._launch_bwd(q.contiguous(), k, v, probs, g.contiguous(), *masks, window, torch.bfloat16)
    for a, b, c in zip(got, same, la.lane_bwd_plain(q, k, v, probs, g, window)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        torch.testing.assert_close(a.float(), c, rtol=2 ** -8, atol=1e-5)


def test_lane_bwd_plan_matches_the_python_mirror(cuda):
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    for t_len in (1, 5, 24, 64, 128):
        for dim in (8, 32, 64):
            for dtype in (torch.bfloat16, torch.float32):
                for window in (0, 16, 31, 32, 40):
                    q = torch.empty(3, 4, t_len, dim, dtype=dtype, device=cuda)
                    assert la.bwd_card_plan(q, window) == la.bwd_plan(t_len, window, dim, dtype)


# -- K7f (banded window attention), redesigned -----------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
def test_banded_kernel_at_every_dim(cuda, dim, dtype):
    """K7f against ``banded_plain`` at every head dim in bf16 and fp32: a
    ragged T = 200 (the fourth query block a quarter full) with ALiBi and a
    third of the environments with no valid key (exactly 0), and W = 160
    (the band's scores in passes of 32, wider than a query block); two calls
    give the same bits."""
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    gen = torch.Generator().manual_seed(dim * 10 + (dtype == torch.float32))
    for n, t_len, window, slopes in ((13, 200, 16, (0.5, 0.25, 0.125, 0.0625)), (5, 70, 160, None)):
        q, k, v, *masks = _banded_inputs(gen, cuda, n, t_len, window, dim, dtype=dtype, invalid=slopes is not None)
        out = ba._launch_fwd(q, k, v, *masks, window, slopes)
        torch.testing.assert_close(out, ba.banded_plain(q, k, v, *masks, window, slopes), **ATT_TOL)
        if slopes is not None:
            assert not out[: n // 3].any()
        assert torch.equal(out, ba._launch_fwd(q, k, v, *masks, window, slopes))


def test_banded_kernel_reads_the_main_paths_views(cuda):
    """The operands as path TL hands them over (q a head-split view of a
    projection, q_seg a transposed view): no copy, the same bits as on
    contiguous copies, one launch a call; at TL's N = 256 against the plain
    version."""
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    gen = torch.Generator().manual_seed(12)
    n, heads, t_len, window, dim = 256, 4, 256, 16, 32
    _, k, v, q_seg, k_seg, k_valid = _banded_inputs(gen, cuda, n, t_len, window)
    proj = torch.randn(t_len * n, 3 * heads * dim, generator=gen).to(cuda, torch.bfloat16)
    q = proj[:, :heads * dim].reshape(t_len, n, heads, dim).permute(1, 2, 0, 3)
    q_seg_t = q_seg.T.contiguous().T
    p, keep = ba._fwd_params(q, k, v, q_seg_t, k_seg, k_valid, window, None)
    assert (p.q, p.q_seg) == (q.data_ptr(), q_seg_t.data_ptr())
    ba.reset_launch_counts()
    out = ba._launch_fwd(q, k, v, q_seg_t, k_seg, k_valid, window, None)
    assert ba.LAUNCHES["K7f"] == 1
    assert torch.equal(out, ba._launch_fwd(q.contiguous(), k, v, q_seg, k_seg, k_valid, window, None))
    torch.testing.assert_close(out, ba.banded_plain(q, k, v, q_seg, k_seg, k_valid, window), **ATT_TOL)


@pytest.mark.parametrize("dim, window", [(16, 2873), (32, 1582), (64, 800), (64, 822)])
def test_banded_kernel_takes_wide_bf16_windows_on_lanes(cuda, dim, window):
    """A bf16 window too wide for the tensor-core staging at 16 queries
    takes the lanes path, up to the widest window the first-slice kernel
    took at each head dim: against ``banded_plain`` with ALiBi and rows with
    no valid key (exactly 0), the card's plan as the mirror's, two calls
    the same bits."""
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    gen = torch.Generator().manual_seed(dim + window)
    n, t_len, slopes = 7, 70, (0.5, 0.25, 0.125, 0.0625)
    q, k, v, *masks = _banded_inputs(gen, cuda, n, t_len, window, dim, invalid=True)
    plan = ba.fwd_card_plan(q, window)
    assert plan == ba.fwd_plan(t_len, window, dim, torch.bfloat16)
    assert plan["tensor_cores"] == 0 and plan["block_q"] > 0
    out = ba._launch_fwd(q, k, v, *masks, window, slopes)
    torch.testing.assert_close(out, ba.banded_plain(q, k, v, *masks, window, slopes), **ATT_TOL)
    assert not out[: n // 3].any()
    assert torch.equal(out, ba._launch_fwd(q, k, v, *masks, window, slopes))


def test_banded_plan_matches_the_python_mirror(cuda):
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    for t_len in (1, 65, 200, 256):
        for dim in (8, 32, 64):
            for dtype in (torch.bfloat16, torch.float32):
                for window in (0, 16, 160, 400):
                    q = torch.empty(3, 4, t_len, dim, dtype=dtype, device=cuda)
                    assert ba.fwd_card_plan(q, window) == ba.fwd_plan(t_len, window, dim, dtype)


# -- K9m (the single-launch PPO step), redesigned ---------------------------------


def test_ppo_step_plan_matches_the_python_mirror(cuda):
    """``mlpm::plan`` against ``weight_images.ppo_step_plan`` (the images
    the wrapper packs, the grid the schedule assumes), within the card's
    shared memory."""
    from cusrl_tpu_torch.nn.kernels import weight_images as wi

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for widths in (WIDTHS, (128, 512, 128), (128, 128), (16, 16), (512, 16), (16, 64, 32), EIGHT_LAYERS):
        for rows in (1, 1000, 24576, 65573):
            for head_dim in (1, 12, 64):
                plan = fm.ppo_step_plan(widths, rows, head_dim)
                assert plan == wi.ppo_step_plan(tuple(widths), rows, sms, head_dim)
                assert plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472


def _mono_case(gen, device, widths, rows, activation):
    (wa, ba), (wc, bc) = _params(gen, device, widths), _params(gen, device, widths)
    heads = [((torch.randn(d, widths[-1], generator=gen) * 0.2).to(device),
              (torch.randn(d, generator=gen) * 0.1).to(device)) for d in (A_DIM, 1)]
    (wm, bm), (wv, bv) = heads
    xs = [torch.tanh(torch.randn(rows, widths[0], generator=gen)).to(device) for _ in range(2)]
    with torch.no_grad():
        mean = fm.mlp_chain_fwd_plain(xs[0], wa, ba, activation, True, False)[0].float() @ wm.T + bm
    std, rows_data = _ppo_rows(gen, device, rows, mean)
    return xs, (wa, ba, wc, bc), (wm, bm, wv, bv, std, *rows_data)


@pytest.mark.parametrize("widths,activation,rows", [
    (WIDTHS, "elu", 24576), (WIDTHS, "elu", 1000), ((16, 64, 32), "relu", 24576 + 17), ((128, 512, 128), "tanh", 130)])
@pytest.mark.parametrize("loss_clip", [None, 0.2])
def test_mono_kernel_gives_splits_bits(cuda, widths, activation, rows, loss_clip):
    """K9m runs K2f's forward tile and K9s's heads, loss and backward tile in
    one kernel: the activations it writes, every gradient and the four loss
    sums equal K2f + K9s's bit for bit (the zoo's widths, one block per SM;
    narrow chains, two blocks per SM and a ragged last tile); and a second
    call repeats them."""
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(rows + len(widths))
    xs, (wa, ba, wc, bc), tail = _mono_case(gen, cuda, widths, rows, activation)
    tail = (*tail, 0.2, 1.0, 0.5, loss_clip, activation, True)
    got, sums, saved = fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)
    again, again_sums, _ = fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)
    outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], activation, True, True, "K2f")
    split_saved = [[*h, o] for h, o in zip(hids, outs)]
    split, split_sums = fp._loss_bwd(xs, split_saved, [wa, wc], *tail)
    torch.cuda.synchronize()
    for hs, ss in zip(saved, split_saved):
        for h, s in zip(hs, ss):
            assert torch.equal(h, s)
    flat = lambda g: [*g[0], *g[1], *g[2], *g[3], *g[4:]]
    for a, b, s in zip(flat(got), flat(again), flat(split)):
        assert torch.equal(a, b) and torch.equal(a, s)
    assert torch.equal(sums, split_sums) and torch.equal(sums, again_sums)
    want, ref_sums = fp.ppo_loss_bwd_plain(xs, saved, [wa, wc], *tail)
    for a, b in zip(flat(got), flat(want)):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all() and (a - b).abs().max() <= 3e-2 * b.abs().max()
    assert ((sums - ref_sums).abs() <= 1e-4 * ref_sums.abs().clamp(min=1.0)).all(), (sums, ref_sums)


AMP_WIDTHS = (48, 512, 256)  # the zoo's Velocity-Flat amp entry: relu actor and critic backbones


@pytest.mark.parametrize("rows", [1024, 4096, 1000])
def test_amp_relu_chain_matches_plain_and_repeats_bitwise(cuda, rows):
    """K1f with relu on AMP's 48-512-256 backbones (primal at the rollout
    step's 1,024 rows, saving at the minibatch's 4,096 and a ragged 1,000)
    and K1b with ``skip_input_grad`` after a saving forward: the relu
    derivative from the saved post-activation; two calls give the same bits."""
    gen = torch.Generator().manual_seed(rows + 3)
    ws, bs = _params(gen, cuda, AMP_WIDTHS)
    x = torch.tanh(torch.randn(rows, AMP_WIDTHS[0], generator=gen)).to(cuda)
    save = rows != 1024
    (out,), (hid,), _ = fm._launch_fwd([x], [ws], [bs], "relu", True, save, "K1f")
    ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, "relu", True, save)
    _close(out, ref, grad=False)
    for h, r in zip(hid, ref_hid):
        _close(h, r, grad=False)
    assert torch.equal(out, fm._launch_fwd([x], [ws], [bs], "relu", True, save, "K1f")[0][0])
    if not save:
        return
    g = (torch.randn(rows, AMP_WIDTHS[-1], generator=gen) * 0.01).to(cuda, torch.bfloat16)
    hs = [*hid, out]
    ((dx, dws, dbs, _),) = fm._launch_bwd([x], [g], [ws], [hs], "relu", True, True, "K1b")
    assert dx is None
    _, rdws, rdbs = fm.mlp_chain_bwd_plain(x, g, ws, hs, "relu", True, True)
    for a, b in zip([*dws, *dbs], [*rdws, *rdbs]):
        _close(a, b, grad=True)
    ((_, again, _, _),) = fm._launch_bwd([x], [g], [ws], [hs], "relu", True, True, "K1b")
    assert all(torch.equal(a, b) for a, b in zip(dws, again))


def _discriminator(fused_kernel: bool):
    from cusrl_tpu_torch.nn.module.mlp import MlpFactory

    factory = MlpFactory(hidden_dims=(512, 256), activation="relu", ends_with_activation=True,
                         compute_dtype="bfloat16", fused_kernel=fused_kernel)
    disc = factory(32, 1, torch.Generator().manual_seed(5))
    with torch.no_grad():
        disc.layers[-1].bias.fill_(0.5)  # a live logit under the trailing relu
    return disc


def test_gradient_penalty_on_the_card_matches_cpu(cuda):
    """AMP's discriminator (32-512-256-1 relu, bf16, ``fused_kernel=False``)
    at 512 rows: the gradient penalty and its gradient with respect to the
    weights (a second derivative) on the card against the CPU, with no kernel
    launched; the weights' gradients within 2e-2 of their largest element."""
    from cusrl_tpu_torch.nn.layer.loss import gradient_penalty

    disc = _discriminator(False)
    x = torch.randn(512, 32, generator=torch.Generator().manual_seed(6))
    results = {}
    fm.reset_launch_counts()
    for device in ("cpu", cuda):
        net = disc.to(device)
        penalty = gradient_penalty(lambda v: net(v)[0], x.to(device))
        grads = torch.autograd.grad(penalty, [l.weight for l in net.layers])
        results[str(device)] = (penalty.cpu(), [g.cpu() for g in grads])
    assert not any(fm.LAUNCHES.values())
    (cpu_penalty, cpu_grads), (card_penalty, card_grads) = results["cpu"], results[str(cuda)]
    assert cpu_penalty > 0
    torch.testing.assert_close(card_penalty, cpu_penalty, rtol=2e-2, atol=0)
    for got, want in zip(card_grads, cpu_grads):
        assert want.abs().max() > 0
        assert (got - want).abs().max() <= 2e-2 * want.abs().max()


def test_second_derivative_through_the_kernel_raises_on_the_card(cuda):
    """A fused relu chain 32-512-256 (K1f/K1b, first-order) under a trainable
    head, as a discriminator with the kernel would run: the gradient
    penalty's backward raises instead of dropping the second-order term."""
    from cusrl_tpu_torch.nn.layer.loss import gradient_penalty
    from cusrl_tpu_torch.nn.module.mlp import MlpFactory

    net = MlpFactory(hidden_dims=(512,), activation="relu", compute_dtype="bfloat16")(
        32, 256, torch.Generator().manual_seed(5)).to(cuda)
    head = torch.nn.Linear(256, 1).to(cuda)
    x = torch.randn(512, 32, generator=torch.Generator().manual_seed(6)).to(cuda)
    fm.reset_launch_counts()
    penalty = gradient_penalty(lambda v: head(net(v)[0].float()), x)
    assert fm.LAUNCHES["K1f"] == 1 and fm.LAUNCHES["K1b"] == 1
    with pytest.raises(RuntimeError, match="once_differentiable"):
        penalty.backward()


# -- Path F: the zoo's Velocity-Flat ppo entry (ELU 48-128-128-128) and its user surface --

F_WIDTHS = (48, 128, 128, 128)


@pytest.mark.parametrize("rows", [64, 4096, 24576, 1000])
def test_f_chains_match_plain(cuda, rows):
    """K1f primal at the Player's 64 rows and the rollout step's 4,096; K2f
    saving and K2b with ``skip_input_grad`` on the joint evaluation's pair
    at the minibatch's 2 x 24,576 rows and a ragged 2 x 1,000."""
    gen = torch.Generator().manual_seed(rows + 11)
    if rows <= 4096:
        ws, bs = _params(gen, cuda, F_WIDTHS)
        x = torch.tanh(torch.randn(rows, F_WIDTHS[0], generator=gen)).to(cuda)
        _check_chain_fwd([x], [ws], [bs], "elu", True, False)
        return
    xs, gs, wss, hss = _chain_inputs(gen, cuda, F_WIDTHS, rows, 2)
    bss = [[(torch.randn(b, generator=gen) * 0.1).to(cuda) for b in F_WIDTHS[1:]] for _ in range(2)]
    _check_chain_fwd(xs, wss, bss, "elu", True, True, "K2f")
    _check_chain_bwd(xs, gs, wss, hss, "elu", True, True, "K2b")


def _f_agent(device, num_instances=256):
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    env = VelocityLocomotionEnv(num_instances=num_instances, device=device)
    return get_experiment("Velocity-Flat", "ppo").make_agent_factory()(env.spec, device=device, seed=7), env


def test_f_checkpoint_round_trips_bitwise_on_the_card(cuda, tmp_path):
    """Two training iterations of path F at 256 environments on the card, a
    checkpoint file, and a fresh card agent that loads it: the same
    ``agent_state`` bit for bit and the same deterministic actions."""
    import numpy as np

    from cusrl_tpu_torch.template.logger import load_checkpoint_file, save_checkpoint_file
    from cusrl_tpu_torch.template.rollout import RolloutDriver

    agent, env = _f_agent(cuda)
    driver = RolloutDriver(agent, env)
    for _ in range(2):
        driver.collect_and_update(24)
        agent.apply_schedules(agent.iteration)
    save_checkpoint_file(str(tmp_path / "ckpt_2.npz"), {"agent": agent.state_dict()})
    saved = load_checkpoint_file(str(tmp_path / "ckpt_2.npz"))["agent"]
    fresh, _ = _f_agent(cuda)
    fresh.load_state_dict(saved)
    again = fresh.state_dict()["agent_state"]
    assert set(again) == set(saved["agent_state"])
    for path, value in saved["agent_state"].items():
        assert again[path].dtype == value.dtype and np.array_equal(again[path], value), path
    obs = torch.tanh(torch.randn(256, 48, generator=torch.Generator().manual_seed(1))).to(cuda)
    for a in (agent, fresh):
        a.set_inference_mode(True)
    assert torch.equal(agent.act(obs), fresh.act(obs))


def test_f_exported_graph_matches_the_kernel_route(cuda, tmp_path):
    """The ``torch_export`` graph of a card agent (plain bf16 layers) on the
    card and on the CPU against the agent's kernel route (K1f at 256 rows),
    within the bf16 limit 2e-2; the graph launches no kernel."""
    from cusrl_tpu_torch.export import load_exported_graph

    agent, _ = _f_agent(cuda)
    norm = agent.get_hook("observation_normalization").observation_rms
    with torch.no_grad():
        norm.mean.uniform_(-0.3, 0.3)
        norm.var.uniform_(0.5, 1.5)
    agent.export(str(tmp_path), batch_size=256, verbose=False)
    obs = torch.tanh(torch.randn(256, 48, generator=torch.Generator().manual_seed(2))).to(cuda)
    fm.reset_launch_counts()
    with torch.no_grad():
        want = agent.actor(norm.normalize(obs))[0]["mean"]
    assert fm.LAUNCHES["K1f"] == 1
    for where in ("cuda", "cpu"):
        call, _ = load_exported_graph(str(tmp_path), device=where)
        with torch.no_grad():
            got = call({"observation": obs.to(where)})["action"].to(cuda)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    assert fm.LAUNCHES["K1f"] == 1


# -- Path H: K1f/K1b with tanh on inputs narrower than the k16 step ------------


@pytest.mark.parametrize("width", [2, 3, 4, 6, 24])
@pytest.mark.parametrize("rows", [256, 1000, 8])
def test_narrow_input_tanh_chain_matches_plain(cuda, width, rows):
    """K1f (saving and primal) and K1b (with dX and with
    ``skip_input_grad``) on a tanh width-64-64 chain, fp32 input of a width
    that is not a multiple of 16 (the gym entries'), against the plain
    versions on the unpadded input; dW_0 and dX come back unpadded."""
    gen = torch.Generator().manual_seed(width * 1000 + rows)
    dims = (width, 64, 64)
    ws, bs = _params(gen, cuda, dims)
    x = torch.randn(rows, width, generator=gen).to(cuda)
    g = (torch.randn(rows, 64, generator=gen) * 0.01).to(cuda, torch.bfloat16)
    fm.reset_launch_counts()
    for save in (True, False):
        (out,), (hid,), _ = fm._launch_fwd([x], [ws], [bs], "tanh", True, save, "K1f")
        ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, "tanh", True, True)
        _close(out, ref, grad=False)
        for h, r in zip(hid, ref_hid):
            _close(h, r, grad=False)
    for skip in (False, True):
        ((dx, dws, dbs, _),) = fm._launch_bwd([x], [g], [ws], [[*ref_hid, ref]], "tanh", True, skip, "K1b")
        rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(x, g, ws, [*ref_hid, ref], "tanh", True, skip)
        assert dws[0].shape == (64, width) and (dx is None) == skip
        for a, b in zip([*dws, *dbs, *([] if skip else [dx])], [*rdws, *rdbs, *([] if skip else [rdx])]):
            _close(a, b, grad=True)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["K1f"] == 2 and fm.LAUNCHES["K1b"] == 2


def test_narrow_input_autograd_and_pair_match_plain(cuda):
    """``fused_mlp`` under autograd (x.grad of the unpadded width) and the
    K2f/K2b pair with input gradients, at input width 4."""
    gen = torch.Generator().manual_seed(4)
    dims = (4, 64, 64)
    (wa, ba), (wc, bc) = _params(gen, cuda, dims), _params(gen, cuda, dims)
    for t in (*wa, *ba, *wc, *bc):
        t.requires_grad_(True)
    xa, xc = (torch.randn(256, 4, generator=gen).to(cuda).requires_grad_() for _ in range(2))
    ga, gc = ((torch.randn(256, 64, generator=gen) * 0.01).to(cuda, torch.bfloat16) for _ in range(2))
    fm.reset_launch_counts()
    out = fm.fused_mlp(xa, wa, ba, "tanh")
    out.backward(ga)
    with torch.no_grad():
        ref, hid = fm.mlp_chain_fwd_plain(xa, wa, ba, "tanh", True, True)
        rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(xa, ga, wa, [*hid, ref], "tanh", True, False)
    _close(out, ref, grad=False)
    assert xa.grad.shape == (256, 4)
    for got, want in zip([xa.grad, *(w.grad for w in wa), *(b.grad for b in ba)], [rdx, *rdws, *rdbs]):
        _close(got, want, grad=True)
    for t in (xa, *wa, *ba):
        t.grad = None
    out_a, out_c = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, "tanh")
    torch.autograd.backward([out_a, out_c], [ga, gc])
    for x, ws, bs, g, o in ((xa, wa, ba, ga, out_a), (xc, wc, bc, gc, out_c)):
        with torch.no_grad():
            ref, hid = fm.mlp_chain_fwd_plain(x, ws, bs, "tanh", True, True)
            rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(x, g, ws, [*hid, ref], "tanh", True, False)
        _close(o, ref, grad=False)
        for got, want in zip([x.grad, *(w.grad for w in ws), *(b.grad for b in bs)], [rdx, *rdws, *rdbs]):
            _close(got, want, grad=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in fm.LAUNCHES.items() if v} == {"K1f": 1, "K1b": 1, "K2f": 1, "K2b": 1}


def test_cartpole_player_step_takes_one_kernel_launch(cuda):
    """The zoo's CartPole-v1 agent in inference mode on the card: a
    deterministic step at the Player's 8 rows is one K1f launch (tanh
    4-64-64), one-hot, the mode of logits that agree with the CPU agent's."""
    import numpy as np

    from cusrl_tpu_torch.environment.native import NativeCartPoleEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = get_experiment("CartPole-v1", "ppo").make_agent_factory()
    spec = NativeCartPoleEnv(8).spec
    agent, cpu_agent = factory(spec, device=cuda, seed=0), factory(spec, device="cpu", seed=0)
    for a in (agent, cpu_agent):
        a.set_inference_mode()
    observation = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    fm.reset_launch_counts()
    action = agent.act(observation)
    assert {k: v for k, v in fm.LAUNCHES.items() if v} == {"K1f": 1}
    assert action.shape == (8, 2) and (action.sum(-1) == 1).all()
    with torch.no_grad():
        logits = agent.actor(torch.from_numpy(observation).to(cuda))[0]["logits"]
        ref = cpu_agent.actor(torch.from_numpy(observation))[0]["logits"]
    torch.testing.assert_close(logits.cpu(), ref, rtol=2e-2, atol=2e-2)


def test_world_one_nccl_update_equals_the_undistributed_one_bit_for_bit(cuda, monkeypatch):
    """Path A's update at full width (8 steps x 256 environments: every
    minibatch on K2f/K2b) through ``distribute_agent`` and
    ``cross_process_update`` over a NCCL group of one against the same update
    without a group, from the same weights, rollout and permutations: the
    collectives run, each the identity, and the metrics and every leaf of the
    agent's state come out bit for bit."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.parallel import cross_process_update, distribute_agent
    from cusrl_tpu_torch.utils import distributed
    from cusrl_tpu_torch.utils.config import configure_distributed
    from cusrl_tpu_torch.utils.interop import state_entries
    from cusrl_tpu_torch.zoo.registry import get_experiment

    steps, envs = 8, 256
    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    factory.num_steps_per_update = steps
    env = VelocityLocomotionEnv(num_instances=envs, device=cuda)
    gen = torch.Generator().manual_seed(17)
    obs = torch.tanh(torch.randn(steps + 1, envs, 48, generator=gen)).to(cuda)
    noise = torch.randn(steps, envs, 12, generator=gen).to(cuda)
    terminated = (torch.rand(steps, envs, 1, generator=gen) < 0.05).to(cuda)
    truncated = (torch.rand(steps, envs, 1, generator=gen) < 0.05).to(cuda)
    perms = torch.stack([torch.randperm(steps * envs // 128, generator=gen) for _ in range(5)])

    def update(distribute):
        agent = factory(env.spec, device=cuda, seed=0)
        with torch.no_grad():
            dist_params, _, _ = agent.actor(obs[:-1])
            action = dist_params["mean"] + dist_params["std"] * noise
            rollout = {"observation": obs[:-1], "next_observation": obs[1:], "action": action,
                       "action_logp": agent.actor.compute_logp(dist_params, action), "action_dist": dist_params,
                       "reward": noise[..., :1], "terminated": terminated, "truncated": truncated,
                       "done": terminated | truncated}
        fm.reset_launch_counts()
        distributed.reset_collective_counts()
        if distribute:
            distribute_agent(agent)
            metrics = cross_process_update(agent, rollout, epoch_perms=perms)
        else:
            metrics = {k: float(v) for k, v in agent.update_body(rollout, epoch_perms=perms).items()}
        counts = {"launches": dict(fm.LAUNCHES), "collectives": distributed.COLLECTIVES["all_reduce"][0]}
        return metrics, {p: np.array(e.read()) for p, e in state_entries(agent).items()}, counts

    plain = update(False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for name, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(name, value)
    assert configure_distributed(timeout_s=120) and dist.get_backend() == "nccl"
    try:
        grouped = update(True)
    finally:
        dist.destroy_process_group()
    assert plain[2]["launches"]["K2f"] == plain[2]["launches"]["K2b"] == 20
    assert grouped[2]["launches"] == plain[2]["launches"] and grouped[2]["collectives"] > 20
    assert plain[2]["collectives"] == 0
    assert grouped[0] == plain[0]
    assert set(grouped[1]) == set(plain[1])
    for path, value in plain[1].items():
        np.testing.assert_array_equal(grouped[1][path], value, err_msg=path)


@pytest.mark.parametrize("host", [False, True])
def test_world_one_nccl_recurrent_update_equals_the_undistributed_one_bit_for_bit(cuda, monkeypatch, host):
    """Path R's update at full width (GRU 256, 8 steps x 256 environments,
    the temporal sampler's minibatches of 64 environments on K1f/K1b) over a
    NCCL group of one against the same update without a group, from the
    same state and a rollout the agent collected: the memories joined, the
    rank's slice of each minibatch, the collectives each the identity; with
    ``host`` through ``agent.update()`` on the ``Buffer`` (the rollout's
    steps pushed).  Metrics and every leaf of the agent's state bit for
    bit."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.template.rollout import RolloutDriver
    from cusrl_tpu_torch.utils import distributed
    from cusrl_tpu_torch.utils.config import configure_distributed
    from cusrl_tpu_torch.utils.interop import state_entries
    from cusrl_tpu_torch.utils.nest import map_nested
    from cusrl_tpu_torch.zoo.registry import get_experiment

    steps, envs = 8, 256
    factory = get_experiment("Velocity-Flat", "recurrent_ppo").make_agent_factory()
    factory.num_steps_per_update = steps
    env = VelocityLocomotionEnv(num_instances=envs, device=cuda)
    source = factory(env.spec, device=cuda, seed=0)
    driver = RolloutDriver(source, env)
    driver.collect(steps)
    rollout, _ = driver.collect(steps)  # the memories warm
    state = {p: np.array(e.read()) for p, e in state_entries(source).items()}
    perms = torch.stack([torch.randperm(envs, generator=torch.Generator().manual_seed(e)) for e in range(5)])

    def update(distribute):
        agent = factory(env.spec, device=cuda, seed=1)
        with torch.no_grad():
            for path, entry in state_entries(agent).items():
                entry.write(path, state[path])
        data = map_nested(lambda x: x.clone(), rollout)
        fm.reset_launch_counts()
        distributed.reset_collective_counts()
        if distribute:
            distribute_agent(agent)
        if host:
            memories = {k for k in data if k.endswith("memory")}
            for t in range(steps):
                agent.buffer.push({k: map_nested(lambda x: x[t], v) for k, v in data.items() if k not in memories})
            agent._initial_memories = {k: map_nested(lambda x: x[0], data[k]) for k in memories}
            update_body = agent.update_body
            agent.update_body = lambda r, **kw: update_body(r, **{**kw, "epoch_perms": perms})
            metrics = agent.update()
        else:
            metrics = {k: float(v) for k, v in agent.update_body(data, epoch_perms=perms).items()}
        counts = {"launches": dict(fm.LAUNCHES), "collectives": distributed.COLLECTIVES["all_reduce"][0]}
        return metrics, {p: np.array(e.read()) for p, e in state_entries(agent).items()}, counts

    plain = update(False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for name, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(name, value)
    assert configure_distributed(timeout_s=120) and dist.get_backend() == "nccl"
    try:
        grouped = update(True)
    finally:
        dist.destroy_process_group()
    assert plain[2]["launches"]["K1f"] > 0 and plain[2]["launches"]["K1b"] == 40
    assert grouped[2]["launches"] == plain[2]["launches"] and grouped[2]["collectives"] > 20
    assert plain[2]["collectives"] == 0
    assert grouped[0] == plain[0]
    assert set(grouped[1]) == set(plain[1])
    for path, value in plain[1].items():
        np.testing.assert_array_equal(grouped[1][path], value, err_msg=path)


# -- paths D, S, SL, X, SC and PO: the auxiliary and control hooks' shapes --------

D_WIDTHS = (48, 256, 128)  # the distillation preset's student, relu
X_WIDTHS = (48, 256, 128, 64)  # RND's target and predictor, ELU
SC_WIDTHS = (48, 256, 128, 16)  # SC's state estimator in its optimization stage, ELU


@pytest.mark.parametrize("widths,activation,rows,chains", [
    (D_WIDTHS, "relu", 4096, 1),  # D's student at the rollout step (primal)
    (D_WIDTHS, "relu", 12288, 1),  # D's student per minibatch
    (WIDTHS, "elu", 49152, 2),  # S's augmented pair
    (WIDTHS, "elu", 24576, 1),  # SL's mirrored actor pass
    (X_WIDTHS, "elu", 98304, 1),  # X's RND passes in pre_update (primal)
    (X_WIDTHS, "elu", 24576, 1),  # X's target and predictor per minibatch
    (SC_WIDTHS, "elu", 24576, 1),  # SC's estimator per minibatch at 24 steps
    (SC_WIDTHS, "elu", 32768, 1),  # ... and at 32 steps (the capacity schedule)
    (WIDTHS, "elu", 32768, 2),  # SC's joint evaluation at 32 steps
    (WIDTHS, "elu", 131072, 1),  # SC's value and KL passes at 32 steps (primal)
    (WIDTHS, "elu", 49152, 2),  # PO's joint evaluation in its 2-minibatch epochs
])
def test_auxiliary_path_shapes_match_plain(cuda, widths, activation, rows, chains):
    """K1f/K1b and K2f/K2b at the shapes paths D, S, SL, X, SC and PO give them: the
    forward primal and saving, the backward with ``skip_input_grad`` (the
    observations take no gradient) after the saving forward."""
    gen = torch.Generator().manual_seed(rows + chains + len(widths))
    params = [_params(gen, cuda, widths) for _ in range(chains)]
    wss, bss = [p[0] for p in params], [p[1] for p in params]
    xs = [torch.tanh(torch.randn(rows, widths[0], generator=gen)).to(cuda) for _ in range(chains)]
    fkey, bkey = ("K1f", "K1b") if chains == 1 else ("K2f", "K2b")
    for save in (False, True):
        outs, hids, _ = fm._launch_fwd(xs, wss, bss, activation, True, save, fkey)
        for x, ws, bs, out in zip(xs, wss, bss, outs):
            _close(out, fm.mlp_chain_fwd_plain(x, ws, bs, activation, True, False)[0], grad=False)
    gs = [(torch.randn(rows, widths[-1], generator=gen) * 0.01).to(cuda, torch.bfloat16) for _ in range(chains)]
    hss = [[*h, o] for h, o in zip(hids, outs)]
    for c, (dx, dws, dbs, _) in enumerate(fm._launch_bwd(xs, gs, wss, hss, activation, True, True, bkey)):
        assert dx is None
        _, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], gs[c], wss[c], hss[c], activation, True, True)
        for a, b in zip([*dws, *dbs], [*rdws, *rdbs]):
            _close(a, b, grad=True)


def test_distillation_expert_stays_frozen_on_the_card(cuda, tmp_path):
    """Path D's expert on the card: loaded from a ``package`` export (the
    file holds a CPU actor), moved to the card, frozen, out of the optimizer;
    its step takes K1f (primal) at the rollout's rows, and an update of the
    student leaves it unchanged and gives it no gradient."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.export import export_agent
    from cusrl_tpu_torch.preset.distillation import DistillationAgentFactory
    from cusrl_tpu_torch.zoo.registry import get_experiment

    env = VelocityLocomotionEnv(num_instances=256, device=cuda)
    teacher = get_experiment("Velocity-Rough", "ppo").make_agent_factory()(env.spec, device=cuda, seed=0)
    export_agent(teacher, str(tmp_path), target_format="package", verbose=False)
    agent = DistillationAgentFactory(expert_path=str(tmp_path), num_steps_per_update=8)(env.spec, device=cuda)
    expert = agent.get_hook("policy_distillation").expert
    assert all(p.is_cuda and not p.requires_grad for p in expert.parameters())
    optimized = {id(p) for group in agent.optimizer.optimizer.param_groups for p in group["params"]}
    assert not optimized & {id(p) for p in expert.parameters()}
    before = [p.detach().clone() for p in expert.parameters()]
    gen = torch.Generator().manual_seed(40)
    obs = torch.tanh(torch.randn(9, 256, 48, generator=gen)).to(cuda)
    transitions = []
    fm.reset_launch_counts()
    for t in range(8):
        tr = agent.act_body(obs[t])
        tr.update(next_observation=obs[t + 1], reward=torch.zeros(256, 1, device=cuda),
                  terminated=torch.zeros(256, 1, dtype=torch.bool, device=cuda),
                  truncated=torch.zeros(256, 1, dtype=torch.bool, device=cuda))
        transitions.append(agent.step_body(tr))
    assert fm.LAUNCHES["K1f"] == 16  # the student's and the expert's step
    rollout = {k: torch.stack([tr[k] for tr in transitions]) for k in transitions[0] if k != "action_dist"}
    rollout["action_dist"] = {k: torch.stack([tr["action_dist"][k] for tr in transitions]) for k in ("mean", "std")}
    agent.update_body(rollout)
    assert all(p.grad is None for p in expert.parameters())
    for a, b in zip(expert.parameters(), before):
        assert torch.equal(a, b)
    with torch.no_grad():
        want, _ = teacher.actor.act_deterministic(obs[0])
    _close(transitions[0]["expert_action"], want, grad=False)
