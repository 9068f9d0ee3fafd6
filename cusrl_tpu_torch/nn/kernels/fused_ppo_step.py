"""Fused PPO + value train step on Hopper (counterpart of
``cusrl_tpu/nn/kernels/fused_ppo_step.py``, in both of its modes).

Split mode (the default) runs the pair forward with saved activations (K2f,
``csrc/mlp_chain_fwd.cu``) and then ONE loss-backward launch (K9s,
``csrc/mlp_chain_bwd.cu`` with its loss prologue), which replaces
``_loss_bwd_kernel`` (``_run_loss_bwd``): from the saved activations it
computes the fp32 heads, the Normal log-probability, the ratio, the clipped
surrogate, the (optionally clipped) value loss, their analytic per-row
gradients, the heads' backward and both chains' backward (no input gradient:
the inputs are rollout data).  dW, db, the heads' gradients, ``dstd`` and four
loss sums come out summed over all rows, deterministically (per-tile partials
summed in tile order).

Mono mode (``CUSRL_TPU_PPO_MODE=mono``, read at import into ``_PPO_MODE`` as
the JAX package does) runs the whole step as one launch (K9m,
``mlp_ppo_step`` in ``csrc/mlp_chain_bwd.cu``), which replaces
``_ppo_step_kernel`` (``_run_ppo_step``): per row tile the chains' forward
(K2f's tile), then the same loss and backward (K9s's tile) from the
activations it has just produced, so that its activations, gradients and
sums are split's, bit for bit.  Its plain version is the split pair's: ``mlp_chain_fwd_plain`` on both chains,
then ``ppo_loss_bwd_plain`` (the arithmetic of ``_ppo_step_kernel`` ->
``_loss_tail``).  The JAX package's mono row tile ``CUSRL_TPU_PPO_BLOCK`` is a
VMEM budget with no counterpart here (the CUDA kernels take 64-row tiles).

Gradient integration is the JAX ``custom_vjp``'s: the forward computes the
parameter gradients of ``loss_core = w_surr * surrogate + w_value *
value_loss`` and keeps them; the backward multiplies them by the incoming 0-d
cotangent on the device, with no host sync.  The four metrics carry no
gradient.  ``std``'s gradient reaches ``std_param`` through the caller's
bijector.

A CPU tensor takes the plain versions (``mlp_chain_fwd_plain`` and
``ppo_loss_bwd_plain``, which repeats K9s's arithmetic with explicit backward
formulas); ``ppo_step_reference`` is the loss written with differentiable
tensor ops, the JAX package's ``ppo_step_reference``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from cusrl_tpu_torch.nn.kernels.fused_mlp import (
    LAUNCHES,
    _chain_fwd,
    _launch_bwd,
    _launch_ppo_step,
    _on_cuda,
    head_bwd_plain,
    mlp_chain_bwd_plain,
    mlp_chain_fwd_parallel,
    mlp_chain_fwd_plain,
    supports_fused_mlp,
)

__all__ = [
    "LAUNCHES",
    "fused_ppo_step",
    "ppo_loss_bwd_plain",
    "ppo_loss_reference",
    "ppo_step_mono_plain",
    "ppo_step_reference",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# "mono": K9m; anything else: split (K2f + K9s), as the JAX package reads it.
_PPO_MODE = os.environ.get("CUSRL_TPU_PPO_MODE", "split")


def _value_loss_terms(vhat, returns, old_value, loss_clip):
    """Per-element value loss and its derivative factor (before the weight):
    ``(terms, dterm/dvhat)`` with the TPU kernel's conventions."""
    u = vhat - returns
    if loss_clip is None:
        return u.square(), 2.0 * u
    delta = vhat - old_value
    w = old_value + torch.clamp(delta, -loss_clip, loss_clip) - returns
    u2, w2 = u.square(), w.square()
    dterm = torch.where(u2 >= w2, 2.0 * u, 2.0 * w * (delta.abs() <= loss_clip).float())
    return torch.maximum(u2, w2), dterm


def ppo_step_reference(xa, xc, weights_a, biases_a, weights_c, biases_c, mean_weight, mean_bias, value_weight,
                       value_bias, std, action, old_logp, advantage, old_value, returns, clip_ratio, w_surr, w_value,
                       activation="elu", trailing=True, loss_clip=None):
    """The objective with differentiable tensor ops (gradients by autograd):
    ``(loss_core, metrics dict)``; numerics of the standard hook trio.  The
    chains are ``mlp_chain_fwd_plain``'s, bit for bit, through the Megatron
    operators where a tensor-parallel agent's weights are shards
    (``mlp_chain_fwd_parallel``)."""
    la = mlp_chain_fwd_parallel(xa, weights_a, biases_a, activation, trailing)
    lc = mlp_chain_fwd_parallel(xc, weights_c, biases_c, activation, trailing)
    return ppo_loss_reference(la, lc, mean_weight, mean_bias, value_weight, value_bias, std, action, old_logp,
                              advantage, old_value, returns, clip_ratio, w_surr, w_value, loss_clip)


def ppo_loss_reference(la, lc, mean_weight, mean_bias, value_weight, value_bias, std, action, old_logp, advantage,
                       old_value, returns, clip_ratio, w_surr, w_value, loss_clip=None):
    """``ppo_step_reference`` from the chains' bf16 outputs ``la`` and ``lc``
    on: the fp32 heads and the PPO + value loss, differentiable by autograd."""
    mean = la.float() @ mean_weight.T + mean_bias
    vhat = lc.float() @ value_weight.T + value_bias
    std = std.float()
    z = (action.float() - mean) / std
    logp = torch.sum(-0.5 * z.square() - torch.log(std) - _LOG_SQRT_2PI, dim=-1, keepdim=True)
    dlt = logp - old_logp.reshape(-1, 1).float()
    ratio = torch.exp(dlt)
    adv = advantage.reshape(-1, 1).float()
    clipped = torch.minimum(torch.maximum(ratio, torch.full_like(ratio, 1.0 - clip_ratio)),
                            torch.full_like(ratio, 1.0 + clip_ratio))
    surrogate = -torch.minimum(adv * ratio, adv * clipped).mean()
    ret = returns.float()
    if loss_clip is None:
        value_loss = (vhat - ret).square().mean()
    else:
        ov = old_value.float()
        clipped_v = ov + torch.clamp(vhat - ov, -loss_clip, loss_clip)
        value_loss = torch.maximum((vhat - ret).square(), (clipped_v - ret).square()).mean()
    loss_core = w_surr * surrogate + w_value * value_loss
    metrics = {
        "surrogate_loss": (w_surr * surrogate).detach(),
        "value_loss": (w_value * value_loss).detach(),
        "ratio": dlt.abs().mean().detach(),
        "value": vhat.sum(-1).mean().detach(),
    }
    return loss_core, metrics


def ppo_loss_bwd_plain(xs, hss, wss, mean_weight, mean_bias, value_weight, value_bias, std, action, old_logp,
                       advantage, old_value, returns, clip_ratio, w_surr, w_value, loss_clip, activation, trailing):
    """Plain version of K9s, step by step with explicit backward formulas
    (``_loss_tail``).  ``hss`` are the two chains' saved ``[h_1..h_L]``.
    Returns ``((dwa, dba, dwc, dbc, dwm, dbm, dwv, dbv, dstd), sums [4])``
    with ``sums = (sum min(t1, t2), sum value-loss terms, sum |dlt|, sum vhat)``."""
    n, v_dim = action.shape[0], value_weight.shape[0]
    mean = hss[0][-1].float() @ mean_weight.T + mean_bias
    vhat = hss[1][-1].float() @ value_weight.T + value_bias
    z = (action - mean) / std
    logp = torch.sum(-0.5 * z.square() - torch.log(std) - _LOG_SQRT_2PI, dim=-1, keepdim=True)
    dlt = logp - old_logp[:, None]
    ratio = torch.exp(dlt)
    adv = advantage[:, None]
    lo, hi = 1.0 - clip_ratio, 1.0 + clip_ratio
    t1, t2 = adv * ratio, adv * torch.clamp(ratio, lo, hi)
    terms, dterm = _value_loss_terms(vhat, returns, old_value, loss_clip)
    sums = torch.stack([torch.minimum(t1, t2).sum(), terms.sum(), dlt.abs().sum(), vhat.sum()])

    inside = ((ratio >= lo) & (ratio <= hi)).float()
    dlogp = (-w_surr / n) * torch.where(t1 <= t2, adv, adv * inside) * ratio
    dmean = dlogp * (z / std)
    dstd = torch.sum(dlogp * ((z.square() - 1.0) / std), dim=0)
    dvhat = (w_value / (n * v_dim)) * dterm
    grads = []
    head_grads = []
    for x, hs, ws, g, w in zip(xs, hss, wss, (dmean, dvhat), (mean_weight, value_weight)):
        d, dw_head, db_head = head_bwd_plain(hs[-1], g, w)
        _, dws, dbs = mlp_chain_bwd_plain(x, d, ws, hs, activation, trailing, True)
        grads += [dws, dbs]
        head_grads += [dw_head, db_head]
    return (*grads, *head_grads, dstd), sums


def ppo_step_mono_plain(xs, bss, wss, mean_weight, mean_bias, value_weight, value_bias, std, action, old_logp,
                        advantage, old_value, returns, clip_ratio, w_surr, w_value, loss_clip, activation, trailing):
    """Plain version of K9m: both chains' forward (``mlp_chain_fwd_plain``,
    saving the activations), then ``ppo_loss_bwd_plain``.  Returns what
    ``ppo_loss_bwd_plain`` returns."""
    hss = []
    for x, ws, bs in zip(xs, wss, bss):
        out, hiddens = mlp_chain_fwd_plain(x, ws, bs, activation, trailing, True)
        hss.append([*hiddens, out])
    return ppo_loss_bwd_plain(xs, hss, wss, mean_weight, mean_bias, value_weight, value_bias, std, action, old_logp,
                              advantage, old_value, returns, clip_ratio, w_surr, w_value, loss_clip, activation,
                              trailing)


@dataclasses.dataclass
class _LossArgs:
    """K9s's loss inputs (fp32, contiguous; ``old_logp`` and ``advantage``
    flat ``[N]``) and outputs (``dstd [A]``, ``sums [4]``)."""

    action: torch.Tensor
    old_logp: torch.Tensor
    advantage: torch.Tensor
    old_value: torch.Tensor | None
    returns: torch.Tensor
    std: torch.Tensor
    clip_ratio: float
    w_surr: float
    w_value: float
    loss_clip: float | None
    dstd: torch.Tensor
    sums: torch.Tensor

    def fill(self, s, num_rows: int, value_dim: int) -> None:
        """Writes the pointers and scalars into the ctypes ``MlpLoss`` ``s``."""
        s.action, s.old_logp, s.advantage = self.action.data_ptr(), self.old_logp.data_ptr(), self.advantage.data_ptr()
        s.old_value = None if self.old_value is None else self.old_value.data_ptr()
        s.returns, s.std = self.returns.data_ptr(), self.std.data_ptr()
        s.dstd, s.sums = self.dstd.data_ptr(), self.sums.data_ptr()
        s.clip_ratio, s.w_surr, s.w_value = self.clip_ratio, self.w_surr, self.w_value
        s.loss_clip = 0.0 if self.loss_clip is None else self.loss_clip
        s.use_old_value = int(self.loss_clip is not None)
        s.inv_n = 1.0 / max(num_rows, 1)
        s.inv_nv = 1.0 / max(num_rows * value_dim, 1)


def _loss_args(xs, wm, wv, std, action, old_logp, advantage, old_value, returns, clip_ratio, w_surr, w_value,
               loss_clip) -> _LossArgs:
    """Checks the loss rows against the chains' inputs and packs them."""
    device = xs[0].device
    n, a_dim, v_dim = xs[0].shape[0], wm.shape[0], wv.shape[0]
    rows = {"action": (action, (n, a_dim)), "old_logp": (old_logp, (n,)), "advantage": (advantage, (n,)),
            "returns": (returns, (n, v_dim)), "std": (std, (a_dim,))}
    if loss_clip is not None:
        rows["old_value"] = (old_value, (n, v_dim))
    for name, (t, shape) in rows.items():
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{name} must be {list(shape)} on {device}; got {tuple(t.shape)} on {t.device}")
    return _LossArgs(
        *(None if t is None else t.detach().float().contiguous()
          for t in (action, old_logp, advantage, old_value if loss_clip is not None else None, returns, std)),
        clip_ratio=float(clip_ratio), w_surr=float(w_surr), w_value=float(w_value),
        loss_clip=None if loss_clip is None else float(loss_clip),
        dstd=torch.empty(a_dim, device=device), sums=torch.empty(4, device=device),
    )


def _loss_bwd(xs, hss, wss, wm, bm, wv, bv, std, action, old_logp, advantage, old_value, returns, clip_ratio,
              w_surr, w_value, loss_clip, activation, trailing):
    """K9s on CUDA tensors, its plain version on CPU tensors: the loss and
    backward from the chains' saved activations ``hss``."""
    if not _on_cuda(xs[0].device):
        return ppo_loss_bwd_plain(xs, hss, wss, wm, bm, wv, bv, std, action, old_logp, advantage, old_value, returns,
                                  clip_ratio, w_surr, w_value, loss_clip, activation, trailing)
    loss = _loss_args(xs, wm, wv, std, action, old_logp, advantage, old_value, returns, clip_ratio, w_surr, w_value,
                      loss_clip)
    (_, dwa, dba, (dwm, dbm)), (_, dwc, dbc, (dwv, dbv)) = _launch_bwd(
        xs, None, wss, hss, activation, trailing, True, "K9s",
        heads=[(wm, bm, None, None), (wv, bv, None, None)], loss=loss,
    )
    return (dwa, dba, dwc, dbc, dwm, dbm, dwv, dbv, loss.dstd), loss.sums


def _ppo_step(xs, bss, wss, wm, bm, wv, bv, std, action, old_logp, advantage, old_value, returns, clip_ratio,
              w_surr, w_value, loss_clip, activation, trailing):
    """K9m on CUDA tensors, its plain version on CPU tensors: the chains'
    forward from their biases ``bss``, then the loss and backward.  Returns
    ``(grads, sums, hiddens)``, ``grads`` and ``sums`` as ``_loss_bwd``'s and
    ``hiddens`` the activations K9m wrote per chain (None on the CPU)."""
    if not _on_cuda(xs[0].device):
        grads, sums = ppo_step_mono_plain(xs, bss, wss, wm, bm, wv, bv, std, action, old_logp, advantage, old_value,
                                          returns, clip_ratio, w_surr, w_value, loss_clip, activation, trailing)
        return grads, sums, None
    loss = _loss_args(xs, wm, wv, std, action, old_logp, advantage, old_value, returns, clip_ratio, w_surr, w_value,
                      loss_clip)
    ((_, dwa, dba, (dwm, dbm)), (_, dwc, dbc, (dwv, dbv))), hiddens = _launch_ppo_step(
        xs, wss, bss, [(wm, bm, None, None), (wv, bv, None, None)], loss, activation, trailing,
    )
    return (dwa, dba, dwc, dbc, dwm, dbm, dwv, dbv, loss.dstd), loss.sums, hiddens


class _FusedPpoStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xa, xc, activation, trailing, num_layers, loss_clip, clip_ratio, w_surr, w_value,
                action, old_logp, advantage, old_value, returns, std, *params):
        nl = num_layers
        wa, ba, wc, bc = params[:nl], params[nl : 2 * nl], params[2 * nl : 3 * nl], params[3 * nl : 4 * nl]
        wm, bm, wv, bv = params[4 * nl :]
        tail = (wm, bm, wv, bv, std, action, old_logp, advantage, old_value, returns, clip_ratio, w_surr, w_value,
                loss_clip, activation, trailing)
        if _PPO_MODE == "mono":  # K9m: forward, loss and backward in one launch
            grads, sums, _ = _ppo_step([xa, xc], [ba, bc], [wa, wc], *tail)
        else:  # K2f saving the activations, then K9s
            outs, hiddens = _chain_fwd([xa, xc], [wa, wc], [ba, bc], activation, trailing, True, "K2f")
            grads, sums = _loss_bwd([xa, xc], [[*hiddens[0], outs[0]], [*hiddens[1], outs[1]]], [wa, wc], *tail)
        dwa, dba, dwc, dbc, dwm, dbm, dwv, dbv, dstd = grads
        n, v_dim = xa.shape[0], wv.shape[0]
        surrogate = -(sums[0] / n)
        value_loss = sums[1] / (n * v_dim)
        loss_core = w_surr * surrogate + w_value * value_loss
        metrics = (w_surr * surrogate, w_value * value_loss, sums[2] / n, sums[3] / n)
        ctx.save_for_backward(dstd, *dwa, *dba, *dwc, *dbc, dwm, dbm, dwv, dbv)
        ctx.mark_non_differentiable(*metrics)
        return (loss_core, *metrics)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, *metric_grads):
        dstd, *param_grads = ctx.saved_tensors
        return (None,) * 14 + (dstd * g,) + tuple(t * g for t in param_grads)


def fused_ppo_step(
    xa: torch.Tensor,
    xc: torch.Tensor,
    weights_a: Sequence[torch.Tensor],
    biases_a: Sequence[torch.Tensor],
    weights_c: Sequence[torch.Tensor],
    biases_c: Sequence[torch.Tensor],
    mean_weight: torch.Tensor,
    mean_bias: torch.Tensor,
    value_weight: torch.Tensor,
    value_bias: torch.Tensor,
    std: torch.Tensor,
    action: torch.Tensor,
    old_logp: torch.Tensor,
    advantage: torch.Tensor,
    old_value: torch.Tensor | None,
    returns: torch.Tensor,
    clip_ratio: float,
    w_surr: float,
    w_value: float,
    activation: str = "elu",
    trailing: bool = True,
    *,
    loss_clip: float | None = None,
):
    """Fused PPO + value train step: returns ``(loss_core, (surrogate_loss,
    value_loss, ratio, value))``.  ``loss_core = w_surr * surrogate + w_value
    * value_loss`` carries the gradients of every parameter (both chains, both
    heads, ``std``); the metrics carry none.  Layouts are the port's: chain
    and head weights ``[out, in]``, biases ``[out]``, ``std`` the fp32 ``[A]``
    state-independent deviation."""
    activation = activation.lower()
    if len(weights_a) != len(weights_c):
        raise ValueError("the two chains must have the same depth")
    if not supports_fused_mlp(activation, len(weights_a), trailing):
        raise ValueError(f"fused_ppo_step does not take activation '{activation}' with {len(weights_a)} layers")
    n = xa.shape[0]
    params = (*weights_a, *biases_a, *weights_c, *biases_c, mean_weight, mean_bias, value_weight, value_bias)
    loss_core, *metrics = _FusedPpoStep.apply(
        xa, xc.to(xa.dtype), activation, trailing, len(weights_a), loss_clip, clip_ratio, w_surr, w_value,
        action.reshape(n, -1).float(), old_logp.reshape(-1).float(), advantage.reshape(-1).float(),
        None if loss_clip is None else old_value.reshape(n, -1).float(), returns.reshape(n, -1).float(),
        std.reshape(-1), *params,
    )
    return loss_core, tuple(metrics)
