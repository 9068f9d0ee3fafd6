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
        (out,), (hid,) = fm._launch_fwd([x], [ws], [bs], activation, trailing, True, "K1f")
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
    outs, hids = fm._launch_fwd(xs, wss, bss, "elu", True, True, "K2f")
    hss = [[*h, o] for h, o in zip(hids, outs)]
    for skip in (False, True):
        got = fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, "K2b")
        for c, (dx, dws, dbs) in enumerate(got):
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
    assert fm.LAUNCHES == {"K1f": 2, "K1b": 1, "K2f": 1, "K2b": 1}


def test_unsupported_width_raises_on_cuda(cuda):
    x = torch.zeros(64, 40, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        fm.fused_mlp(x, [torch.zeros(64, 40, device=cuda)], [torch.zeros(64, device=cuda)])
