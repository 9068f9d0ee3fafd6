"""Device times of the band attention kernels on the card: K3f (saving the
probabilities at N = 256, primal at N = 1,024), K3b (N = 256: fp32 outputs,
and bf16 where the checkout's wrapper writes them) and K6 (N = 1,024) at the
zoo transformer's shapes (4 heads, T = 24, W = 16, D = 32, bf16), and K7f at
path TL's (T = 256: N = 256 and 1,024).

    python3 probe_attention.py [--label NAME] [--repeats N]

For each kernel: its device ms per launch by kernel name (torch.profiler,
mean over the profiled calls), the call's ms by CUDA events (median of ten)
and the wrapper's host ms per call, each through the timing helpers of the
checkout's own ``chip_smoke.py``.  It touches only the kernel wrappers'
long-standing entry points and helpers that ``chip_smoke.py`` has had since
the lane kernels were first redesigned, so a copy of this script runs in an
older checkout too: unpack one with ``git archive`` into the ignored
``_archive/``, copy the script there, and run both in turns in one call
(old, new, new, old) to compare on one card.  Prints the card's name and
power limit and one JSON line per run.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def _device_ms(cs, fn, namespace: str, symbol: str, repeats: int) -> float | None:
    """Mean device ms per launch of the kernel ``namespace::symbol`` over
    ``repeats`` calls (up to ``PROFILE_ATTEMPTS`` profiler sessions); None
    where no session records it."""
    for _ in range(cs.PROFILE_ATTEMPTS):
        found = cs._profiled_kernels(fn, (namespace,), repeats, 3)[0]
        for key, count, us in found:
            if symbol in key and count:
                return us / count / 1e3
    return None


def main(argv: list[str]) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default=str(REPO))
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_attention: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    window, calls = cs.T_WINDOW, {}
    q, k, v, *masks = cs._lane_inputs(gen, device, cs.T_MB_ENVS)
    calls["K3f"] = (lambda: la._launch_fwd(q, k, v, *masks, window, None, True), "lane", "lane_fwd_kernel")
    _, probs = la.lane_fwd_plain(q, k, v, *masks, window, None, True)
    g = torch.randn(q.shape, generator=gen).to(device)
    calls["K3b fp32 out"] = (lambda: la._launch_bwd(q, k, v, probs, g, *masks, window), "lane", "lane_bwd_kernel")
    if "out_dtype" in inspect.signature(la._launch_bwd).parameters:
        calls["K3b bf16 out"] = (lambda: la._launch_bwd(q, k, v, probs, g, *masks, window, torch.bfloat16),
                                 "lane", "lane_bwd_kernel")
    q1, k1, v1, *masks1 = cs._lane_inputs(gen, device, cs.T_ENVS)
    calls["K3f primal"] = (lambda: la._launch_fwd(q1, k1, v1, *masks1, window, None, False), "lane",
                           "lane_fwd_kernel")
    k_self, v_self = (torch.randn(q1.shape, generator=gen).to(device, torch.bfloat16) for _ in range(2))
    calls["K6"] = (lambda: la._launch_next(q1, k_self, v_self, k1, v1, *masks1, window, None), "lane",
                   "lane_next_kernel")
    for n in (cs.T_MB_ENVS, cs.T_ENVS):
        qb, kb, vb, *mb = cs._lane_inputs(gen, device, n, cs.TL_STEPS)
        calls[f"K7f N={n}"] = ((lambda qb=qb, kb=kb, vb=vb, mb=mb: ba._launch_fwd(qb, kb, vb, *mb, window, None)),
                               "banded", "banded_fwd_kernel")
    results = {}
    for name, (fn, namespace, symbol) in calls.items():
        device_ms = _device_ms(cs, fn, namespace, symbol, args.repeats)
        results[name] = dict(device_ms=device_ms, events_ms=cs._time_ms(fn), host_ms=cs._host_ms(fn))
        shown = "not measured" if device_ms is None else f"{device_ms:.4f}"
        print(f"[probe] {args.label} {name:14s} device_ms={shown} events_ms={results[name]['events_ms']:.4f} "
              f"host_ms={results[name]['host_ms']:.4f}")
    print(smi)
    print(json.dumps({"label": args.label, "card": smi, "kernels": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
