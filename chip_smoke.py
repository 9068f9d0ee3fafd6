#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``cusrl_tpu_torch``) runs its main path
on one NVIDIA GPU (built for an H100, ``sm_90a``).

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing its own lines; any failure raises and exits non-zero
without printing a result:

1. the card, its power limit and PyTorch's name for it;
2. build the hand-written kernels (``cusrl_tpu_torch/csrc/*.cu``, one ``nvcc``
   per source, all at once) and print the build seconds and ptxas usage;
3. hold each kernel (K1f, K1b, K2f, K2b) against its plain PyTorch version on
   the card at the main-path shapes and at a ragged row count, and time the
   kernel, the plain version and a bf16 ``F.linear`` chain (a yardstick only;
   the port never calls it) with CUDA events;
4. hold the wrappers the port calls (``fused_mlp``, ``fused_mlp_pair`` and
   their autograd Functions) against the plain versions at main-path shapes:
   outputs and every parameter's ``.grad`` after ``backward``;
5. hold one whole update on the card against the same update through the
   port's plain CPU path, at full width on a small rollout;
6. train: Velocity-Rough MLP PPO (512-256-128 ELU actor and critic, 4096
   environments, 24 steps per update, 5 epochs x 4 minibatches, joint
   actor-critic evaluation) for a warm-up and a few timed iterations, with the
   launch counters set to 0 just before and read just after;
7. the ``nvidia-smi`` line, the ``kernels`` JSON line, and the final
   ``{"ok": true, ...}`` line.

Depth is not cut: the slice's model is 3 hidden layers.  Weights are random,
from seed 0.  There is no CPU fallback: without CUDA the script exits 2.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
WIDTHS = (48, 512, 256, 128)  # Velocity-Rough: 48-D observations, 512-256-128 backbones
NUM_ENVS, STEPS, EPOCHS, MINIBATCHES = 4096, 24, 5, 4
MINIBATCH_ROWS = NUM_ENVS * STEPS // MINIBATCHES  # 24,576
RAGGED_ROWS = 1000
TIMED_ITERATIONS = 5
EXPECTED_LAUNCHES_PER_ITERATION = {"K1f": STEPS + 3, "K1b": 0, "K2f": EPOCHS * MINIBATCHES, "K2b": EPOCHS * MINIBATCHES}

# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel-vs-plain tolerances.  Forward outputs are bf16: the two sides
# accumulate in another order, so a value can round to the neighbouring bf16
# number (2^-8 relative) and that step can propagate through later layers.
# Gradients are fp32 sums over many rows of products of bf16 values; a flipped
# bf16 rounding of d moves a sum by ~2^-8 of one term.
FWD_RTOL, FWD_ATOL = 2e-2, 2e-2
GRAD_REL = 1e-2  # max |kernel - plain| <= GRAD_REL * max |plain|

REPLACES = {
    "K1f": "cusrl_tpu/nn/kernels/fused_mlp.py:256",
    "K1b": "cusrl_tpu/nn/kernels/fused_mlp.py:293",
    "K2f": "cusrl_tpu/nn/kernels/fused_mlp.py:567",
    "K2b": "cusrl_tpu/nn/kernels/fused_mlp.py:604",
}
SOURCES = {
    "K1f": "cusrl_tpu_torch/csrc/mlp_chain_fwd.cu",
    "K1b": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
    "K2f": "cusrl_tpu_torch/csrc/mlp_chain_fwd.cu",
    "K2b": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
}
NOT_PORTED = {
    "K8": "cusrl_tpu/nn/kernels/fused_mlp.py:960",
    "K9": "cusrl_tpu/nn/kernels/fused_ppo_step.py:289",
    "K3": "cusrl_tpu/nn/kernels/lane_attention.py:204",
    "K6": "cusrl_tpu/nn/kernels/lane_attention.py:385",
    "K7": "cusrl_tpu/nn/kernels/banded_attention.py:202",
    "K4": "cusrl_tpu/nn/kernels/fused_block.py:193",
    "K5": "cusrl_tpu/nn/kernels/fused_block.py:696",
}


def _time_ms(fn, repeats: int = 10, warmup: int = 3) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _chain_work(rows: int, chains: int, backward: bool, save_hiddens: bool, input_grad: bool):
    """(FLOP, bytes) the function must do and move: each input read once,
    each output written once."""
    pairs = [(WIDTHS[i], WIDTHS[i + 1]) for i in range(len(WIDTHS) - 1)]
    macs = sum(a * b for a, b in pairs)
    params = macs + sum(b for _, b in pairs)
    hidden = sum(b for _, b in pairs[:-1])
    if not backward:
        flops = 2 * rows * macs
        nbytes = rows * WIDTHS[0] * 4 + params * 4 + rows * WIDTHS[-1] * 2 + (rows * hidden * 2 if save_hiddens else 0)
    else:
        dx_macs = sum(a * b for a, b in (pairs if input_grad else pairs[1:]))
        flops = 2 * rows * (macs + dx_macs)
        nbytes = (rows * WIDTHS[0] * 4 + rows * WIDTHS[-1] * 2 + rows * (hidden + WIDTHS[-1]) * 2  # x, g, saved h
                  + macs * 4 + params * 4 + (rows * WIDTHS[0] * 4 if input_grad else 0))  # W, dW + db, dx
    return chains * flops, chains * nbytes


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _params(generator, device):
    import torch

    ws, bs = [], []
    for a, b in zip(WIDTHS[:-1], WIDTHS[1:]):
        ws.append((torch.randn(b, a, generator=generator) / math.sqrt(a)).to(device))
        bs.append((torch.randn(b, generator=generator) * 0.1).to(device))
    return ws, bs


def _check(name: str, got, want, rel: bool) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    if rel:
        limit = GRAD_REL * want.abs().max().item()
        ok = err <= limit
    else:
        ok = bool(torch.allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL))
        limit = FWD_ATOL + FWD_RTOL * want.abs().max().item()
    print(f"    {name:28s} max_abs_err={err:.3e} (limit {limit:.3e}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err {err:.3e})")
    return err


def _library_fwd(xs, wss, bss, save):
    """The yardstick: a bf16 F.linear + ELU chain per net (autograd graph kept when ``save``)."""
    import torch
    import torch.nn.functional as F

    outs = []
    for x, ws, bs in zip(xs, wss, bss):
        h = x.to(torch.bfloat16)
        for w, b in zip(ws, bs):
            h = F.elu(F.linear(h, w, b))
        outs.append(h)
    return outs


def check_kernels(device) -> dict:
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED)
    wa, ba = _params(gen, device)
    wc, bc = _params(gen, device)
    wa16 = [w.to(torch.bfloat16).requires_grad_() for w in wa]
    ba16 = [b.to(torch.bfloat16).requires_grad_() for b in ba]
    wc16 = [w.to(torch.bfloat16).requires_grad_() for w in wc]
    bc16 = [b.to(torch.bfloat16).requires_grad_() for b in bc]
    results = {}

    def obs(rows):
        return torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(device)

    def cotangent(rows):
        return (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(device, torch.bfloat16)

    # -- K1f: single-chain forward (rollout actor, whole-rollout critic/actor passes)
    print("[kernels] K1f mlp_chain_fwd x1")
    errs = []
    for rows, save in ((4096, False), (NUM_ENVS * STEPS, False), (RAGGED_ROWS, True)):
        x = obs(rows)
        (out,), (hid,) = fm._launch_fwd([x], [wa], [ba], "elu", True, save, "K1f")
        ref, ref_hid = fm.mlp_chain_fwd_plain(x, wa, ba, "elu", True, save)
        torch.cuda.synchronize()
        errs.append(_check(f"out rows={rows}", out, ref, rel=False))
        for i, (h, r) in enumerate(zip(hid, ref_hid)):
            errs.append(_check(f"h{i + 1} rows={rows}", h, r, rel=False))
    x = obs(NUM_ENVS * STEPS)
    k_ms = _time_ms(lambda: fm._launch_fwd([x], [wa], [ba], "elu", True, False, "K1f"))
    p_ms = _time_ms(lambda: fm.mlp_chain_fwd_plain(x, wa, ba, "elu", True, False))
    with torch.no_grad():
        l_ms = _time_ms(lambda: _library_fwd([x], [wa16], [ba16], False))
    bound, by = _bound_ms(*_chain_work(NUM_ENVS * STEPS, 1, False, False, False))
    x4 = obs(4096)
    k4_ms = _time_ms(lambda: fm._launch_fwd([x4], [wa], [ba], "elu", True, False, "K1f"))
    bound4, _ = _bound_ms(*_chain_work(4096, 1, False, False, False))
    print(f"    rows=98304: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
    print(f"    rows=4096:  kernel_ms={k4_ms:.4f} bound_ms={bound4:.4f}")
    results["K1f"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="98304 x 48-512-256-128", rollout_step_ms=k4_ms, rollout_step_bound_ms=bound4)

    # -- K2f: pair forward with saved activations (every minibatch)
    print("[kernels] K2f mlp_chain_fwd x2 (saves hiddens)")
    errs = []
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        xa, xc = obs(rows), obs(rows)
        outs, hids = fm._launch_fwd([xa, xc], [wa, wc], [ba, bc], "elu", True, True, "K2f")
        for tag, x, ws, bs, out, hid in (("a", xa, wa, ba, outs[0], hids[0]), ("c", xc, wc, bc, outs[1], hids[1])):
            ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
            torch.cuda.synchronize()
            errs.append(_check(f"out_{tag} rows={rows}", out, ref, rel=False))
            for i, (h, r) in enumerate(zip(hid, ref_hid)):
                errs.append(_check(f"h{i + 1}_{tag} rows={rows}", h, r, rel=False))
    xa, xc = obs(MINIBATCH_ROWS), obs(MINIBATCH_ROWS)
    k_ms = _time_ms(lambda: fm._launch_fwd([xa, xc], [wa, wc], [ba, bc], "elu", True, True, "K2f"))
    p_ms = _time_ms(lambda: [fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
                             for x, ws, bs in ((xa, wa, ba), (xc, wc, bc))])
    with torch.enable_grad():
        l_ms = _time_ms(lambda: _library_fwd([xa, xc], [wa16, wc16], [ba16, bc16], True))
    bound, by = _bound_ms(*_chain_work(MINIBATCH_ROWS, 2, False, True, False))
    print(f"    rows=24576: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
    results["K2f"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="2 x 24576 x 48-512-256-128")

    # -- K2b: pair backward, skip_input_grad (every minibatch); K1b: single chain with dX
    for key, chains, skip in (("K2b", 2, True), ("K1b", 1, False)):
        print(f"[kernels] {key} mlp_chain_bwd x{chains}{' (skip_input_grad)' if skip else ''}")
        wss, bss = [wa, wc][:chains], [ba, bc][:chains]
        fwd_key = "K2f" if chains == 2 else "K1f"
        errs = []
        for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
            xs = [obs(rows) for _ in range(chains)]
            gs = [cotangent(rows) for _ in range(chains)]
            outs, hids = fm._launch_fwd(xs, wss, bss, "elu", True, True, fwd_key)
            hss = [[*h, o] for h, o in zip(hids, outs)]
            got = fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, key)
            for c, (dx, dws, dbs) in enumerate(got):
                rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], gs[c], wss[c], hss[c], "elu", True, skip)
                torch.cuda.synchronize()
                for l, (a, b) in enumerate(zip(dws, rdws)):
                    errs.append(_check(f"dW{l}[{c}] rows={rows}", a, b, rel=True))
                for l, (a, b) in enumerate(zip(dbs, rdbs)):
                    errs.append(_check(f"db{l}[{c}] rows={rows}", a, b, rel=True))
                if skip:
                    assert dx is None
                else:
                    errs.append(_check(f"dx[{c}] rows={rows}", dx, rdx, rel=True))
        xs = [obs(MINIBATCH_ROWS) for _ in range(chains)]
        gs = [cotangent(MINIBATCH_ROWS) for _ in range(chains)]
        outs, hids = fm._launch_fwd(xs, wss, bss, "elu", True, True, fwd_key)
        hss = [[*h, o] for h, o in zip(hids, outs)]
        k_ms = _time_ms(lambda: fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, key))
        p_ms = _time_ms(lambda: [fm.mlp_chain_bwd_plain(xs[c], gs[c], wss[c], hss[c], "elu", True, skip)
                                 for c in range(chains)])
        with torch.enable_grad():
            lib_w = [wa16, wc16][:chains]
            lib_b = [ba16, bc16][:chains]
            lib_x = [x.clone().requires_grad_(not skip) for x in xs]
            lib_out = _library_fwd(lib_x, lib_w, lib_b, True)
            inputs = [p for ws_, bs_ in zip(lib_w, lib_b) for p in (*ws_, *bs_)] + ([] if skip else lib_x)
            l_ms = _time_ms(lambda: torch.autograd.grad(lib_out, inputs, gs, retain_graph=True))
        bound, by = _bound_ms(*_chain_work(MINIBATCH_ROWS, chains, True, True, not skip))
        print(f"    rows=24576: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        results[key] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                            library_ms=l_ms, shape=f"{chains} x 24576 x 48-512-256-128")
    return results


def check_wrappers(device) -> dict:
    """The wrappers the port calls (``fused_mlp``, ``fused_mlp_pair`` and
    their autograd Functions) against the plain versions at main-path shapes:
    outputs, and every parameter's ``.grad`` after ``backward`` with a fixed
    cotangent.  This holds the layer above the launchers: the gradient order,
    the zero cotangent of an unused output, the ``skip_input_grad`` decision
    and the dtype casts.  Returns the largest error per kernel."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 3)
    errs = {"K1f": [], "K1b": [], "K2f": [], "K2b": []}

    def leaf_params():
        ws, bs = _params(gen, device)
        return [w.requires_grad_() for w in ws], [b.requires_grad_() for b in bs]

    def obs(rows):
        return torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(device)

    def cotangent(rows):
        return (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(device, torch.bfloat16)

    def plain(x, ws, bs, g, skip):
        with torch.no_grad():
            out, hid = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
            return out, fm.mlp_chain_bwd_plain(x, g, ws, [*hid, out], "elu", True, skip)

    def grads(key, tag, ws, bs, want_dws, want_dbs):
        for l, (w, want) in enumerate(zip(ws, want_dws)):
            errs[key].append(_check(f"{tag} W{l}.grad", w.grad, want, rel=True))
        for l, (b, want) in enumerate(zip(bs, want_dbs)):
            errs[key].append(_check(f"{tag} b{l}.grad", b.grad, want, rel=True))

    # fused_mlp without grad: the rollout actor (4,096 rows) and the
    # whole-rollout passes (98,304 rows); the primal launch saves nothing.
    print("[wrappers] fused_mlp, no grad")
    wa, ba = leaf_params()
    for rows in (NUM_ENVS, NUM_ENVS * STEPS):
        x = obs(rows)
        before = fm.LAUNCHES["K1f"]
        with torch.no_grad():
            out = fm.fused_mlp(x, wa, ba)
        ref, _ = fm.mlp_chain_fwd_plain(x, wa, ba, "elu", True, False)
        if fm.LAUNCHES["K1f"] != before + 1:
            raise AssertionError("fused_mlp did not launch K1f")
        errs["K1f"].append(_check(f"out rows={rows}", out, ref, rel=False))

    # fused_mlp with grad, the input too: K1f saving hiddens, then K1b with dX.
    print("[wrappers] fused_mlp, grad of input and parameters")
    x = obs(RAGGED_ROWS).requires_grad_()
    g = cotangent(RAGGED_ROWS)
    before = dict(fm.LAUNCHES)
    out = fm.fused_mlp(x, wa, ba)
    out.backward(g)
    if fm.LAUNCHES["K1f"] != before["K1f"] + 1 or fm.LAUNCHES["K1b"] != before["K1b"] + 1:
        raise AssertionError("fused_mlp with grad did not launch K1f and K1b once each")
    ref, (rdx, rdws, rdbs) = plain(x.detach(), wa, ba, g, False)
    errs["K1f"].append(_check(f"out rows={RAGGED_ROWS}", out, ref, rel=False))
    if x.grad is None or x.grad.dtype != x.dtype:
        raise AssertionError("fused_mlp returned no input gradient of the input's dtype")
    errs["K1b"].append(_check(f"x.grad rows={RAGGED_ROWS}", x.grad, rdx, rel=True))
    grads("K1b", f"rows={RAGGED_ROWS}", wa, ba, rdws, rdbs)

    # fused_mlp_pair as joint evaluation calls it: data inputs, parameters
    # that need grad, skip_input_grad=True; then only the actor's output used,
    # so the critic's cotangent is the zero fill.
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        print(f"[wrappers] fused_mlp_pair, skip_input_grad, rows={rows}")
        wa, ba = leaf_params()
        wc, bc = leaf_params()
        xa, xc = obs(rows), obs(rows)
        ga, gc = cotangent(rows), cotangent(rows)
        before = dict(fm.LAUNCHES)
        out_a, out_c = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, skip_input_grad=True)
        torch.autograd.backward([out_a, out_c], [ga, gc])
        if fm.LAUNCHES["K2f"] != before["K2f"] + 1 or fm.LAUNCHES["K2b"] != before["K2b"] + 1:
            raise AssertionError("fused_mlp_pair did not launch K2f and K2b once each")
        for tag, x, ws, bs, g, out in (("a", xa, wa, ba, ga, out_a), ("c", xc, wc, bc, gc, out_c)):
            ref, (rdx, rdws, rdbs) = plain(x, ws, bs, g, True)
            if rdx is not None:
                raise AssertionError("plain backward returned an input gradient under skip_input_grad")
            errs["K2f"].append(_check(f"out_{tag} rows={rows}", out, ref, rel=False))
            grads("K2b", f"{tag} rows={rows}", ws, bs, rdws, rdbs)
        if rows != MINIBATCH_ROWS:
            continue
        for p in (*wa, *ba, *wc, *bc):
            p.grad = None
        out_a, _ = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, skip_input_grad=True)
        out_a.backward(ga)
        _, (_, rdws, rdbs) = plain(xa, wa, ba, ga, True)
        grads("K2b", f"a, c unused rows={rows}", wa, ba, rdws, rdbs)
        for p in (*wc, *bc):
            if p.grad is not None and p.grad.abs().max().item() != 0.0:
                raise AssertionError("an unused output's zero cotangent gave a non-zero gradient")
        print("    c unused: critic gradients are zero")
    return {k: max(v) for k, v in errs.items()}


def _slice_factory(**overrides):
    from cusrl_tpu_torch.preset.ppo import PpoAgentFactory

    kwargs = dict(
        num_steps_per_update=STEPS,
        actor_hidden_dims=WIDTHS[1:],
        critic_hidden_dims=WIDTHS[1:],
        activation_fn="elu",
        lr=1e-3,
        sampler_epochs=EPOCHS,
        sampler_mini_batches=MINIBATCHES,
        entropy_loss_weight=0.005,
        fuse_actor_critic_evaluation=True,
    )
    kwargs.update(overrides)
    return PpoAgentFactory(**kwargs)


def check_update_against_cpu() -> None:
    """One whole update at full width on a small rollout (8 steps x 256
    environments: every backbone call is large enough for the kernels), on
    the card and through the plain CPU path, same weights, rollout and
    permutations.  Metrics agree within bf16 rounding carried through 20 Adam
    steps (rtol 2e-2, atol 2e-3): KL and the importance-weighted advantage
    are small differences of nearly equal terms, and the CPU side's matmuls
    block differently on each host."""
    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    steps, envs = 8, 256
    gen = torch.Generator().manual_seed(SEED + 1)
    obs = torch.tanh(torch.randn(steps + 1, envs, WIDTHS[0], generator=gen))
    terminated = torch.rand(steps, envs, 1, generator=gen) < 0.05
    truncated = torch.rand(steps, envs, 1, generator=gen) < 0.05
    metrics = {}
    for device in ("cpu", "cuda"):
        env = VelocityLocomotionEnv(num_instances=envs, device=device)
        agent = _slice_factory(num_steps_per_update=steps)(env.spec, device=device, seed=SEED)
        with torch.no_grad():
            dist, _, _ = agent.actor(obs[:-1].to(device))
        noise = torch.randn(steps, envs, 12, generator=torch.Generator().manual_seed(SEED + 2)).to(device)
        action = dist["mean"] + dist["std"] * noise
        rollout = {
            "observation": obs[:-1].to(device),
            "next_observation": obs[1:].to(device),
            "action": action,
            "action_logp": agent.actor.compute_logp(dist, action),
            "action_dist": dist,
            "reward": torch.ones(steps, envs, 1, device=device),
            "terminated": terminated.to(device),
            "truncated": truncated.to(device),
            "done": (terminated | truncated).to(device),
        }
        perms = torch.stack([torch.randperm(steps * envs // 128, generator=torch.Generator().manual_seed(e))
                             for e in range(EPOCHS)])
        fm.reset_launch_counts()
        metrics[device] = {k: float(v) for k, v in agent.update_body(rollout, epoch_perms=perms).items()}
        if device == "cuda":
            launched = dict(fm.LAUNCHES)
    print(f"[update-check] cuda launches {launched}")
    if launched["K2f"] != EPOCHS * MINIBATCHES or launched["K2b"] != EPOCHS * MINIBATCHES or launched["K1f"] != 3:
        raise AssertionError(f"small update did not run through the kernels: {launched}")
    for key, ref in sorted(metrics["cpu"].items()):
        got = metrics["cuda"][key]
        ok = math.isfinite(got) and abs(got - ref) <= 2e-3 + 2e-2 * abs(ref)
        print(f"    {key:32s} cuda={got:.6f} cpu={ref:.6f} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"update metric '{key}' disagrees between the card and the CPU path")


def train(kind: str) -> dict:
    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.template.rollout import RolloutDriver

    env = VelocityLocomotionEnv(num_instances=NUM_ENVS, seed=SEED)  # device defaults to the card
    agent = _slice_factory()(env.spec, seed=SEED)
    driver = RolloutDriver(agent, env)
    start = time.perf_counter()
    driver.collect_and_update(STEPS)  # warm-up
    torch.cuda.synchronize()
    print(f"[train] warm-up iteration {time.perf_counter() - start:.3f} s")

    fm.reset_launch_counts()
    start = time.perf_counter()
    history = []
    for _ in range(TIMED_ITERATIONS):
        aggregates, metrics = driver.collect_and_update(STEPS)
        history.append((aggregates, metrics))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(fm.LAUNCHES)

    expected = {k: v * TIMED_ITERATIONS for k, v in EXPECTED_LAUNCHES_PER_ITERATION.items()}
    print(f"[train] launches over {TIMED_ITERATIONS} iterations: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the training loop did not launch the kernels the expected number of times")
    for i, (aggregates, metrics) in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()) or not torch.isfinite(aggregates).all():
            raise AssertionError(f"non-finite metrics at iteration {i}: {values}")
        print(f"    iteration {i}: " + " ".join(f"{k}={v:.5g}" for k, v in sorted(values.items())))
    steps_per_s = TIMED_ITERATIONS * STEPS * NUM_ENVS / elapsed
    print(f"[train] {steps_per_s:.1f} env-steps/s ({elapsed / TIMED_ITERATIONS * 1e3:.2f} ms per iteration) on {kind}")
    profile_iteration(driver)
    return launches


def profile_iteration(driver) -> None:
    """Device time by kernel over one training iteration (torch.profiler),
    and the device's idle share of the iteration's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        driver.collect_and_update(STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = []
    for event in prof.key_averages():
        # Device-side events only (kernels, copies, fills): a CPU op's device
        # time repeats the time of the kernels it launched.
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us = getattr(event, "self_device_time_total", 0) or getattr(event, "self_cuda_time_total", 0)
        if device_us > 0:
            rows.append((device_us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] one iteration: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on)")
    for ms, count, name in rows[:12]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "cusrl_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the cusrl_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions run true fp32 products
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    from cusrl_tpu_torch.nn.kernels import build

    start = time.perf_counter()
    build.build_all()
    print(f"[build] {time.perf_counter() - start:.1f} s (nvcc, sources compiled in parallel)")
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {log.stem}: {line.strip()}")

    device = torch.device("cuda", 0)
    results = check_kernels(device)
    for key, err in check_wrappers(device).items():
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    check_update_against_cpu()
    launches = train(kind)

    kernels = []
    for key in ("K1f", "K1b", "K2f", "K2b"):
        r = results[key]
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[key], "replaces": REPLACES[key],
            "launches": launches[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "status": "ported and checked",
        })
    for key, where in NOT_PORTED.items():
        print(f"[kernels] {key} ({where}): not ported")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
