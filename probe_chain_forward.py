#!/usr/bin/env python3
"""Where the MLP chain forward's time goes on the card: the device time of
``cusrl_tpu_torch/csrc/mlp_chain_fwd.cu`` (K1f, K2f, K8f) with one part taken
out or done another way, at the zoo's shapes, and the wrapper's host time of
the rollout step's head with its images resident and streamed.

Run from the root of a checkout, on a machine with one card:

    python3 probe_chain_forward.py

Each variant is the kernel's source with textual substitutions, built with
the package's ``nvcc`` flags into ``cusrl_tpu_torch/_build/probe/<variant>/``
(one ``nvcc`` each, all at once) and launched through the wrapper
``fused_mlp._launch_fwd`` in this process.  Device ms: ``torch.profiler`` by
kernel name (``mlpf::``: the chain kernel + the pack kernel where the images
stream), the mean per call over 10 calls after 3 warm-up calls.  Host us: the
wrapper's time per call over 200 calls.  A variant that takes a part out
gives other outputs, so nothing here is checked against the plain version:
it measures, ``chip_smoke.py`` and the ``gpu`` tests check.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HEADERS = ("hopper_wg.cuh", "mlp_chain.cuh")
SOURCE = "mlp_chain_fwd.cu"

_EPILOGUE = (
    "      wg::add_bias_round(d, bias + c0, cols, f);\n",
    "      if (dst != nullptr && keep_z) wg::store_bf16(d, cols, dst, N, c0, row0, n_rows, f);\n",
    "      if (apply_act) mlp::activate(d, act);\n",
    "      if (dst != nullptr && !keep_z) wg::store_bf16(d, cols, dst, N, c0, row0, n_rows, f);\n",
    "      if (to_smem) wg::to_tile(d, max(0, min(NW, wg::pad64(N) - c0)), next, f, c0);\n",
)
_ELU = "case 1: return fmaxf(z, 0.f) + (expf(fminf(z, 0.f)) - 1.f);"
# (substitutions, images streamed where the plan keeps them resident)
VARIANTS = {
    "kernel": ([], False),
    "no activation": ([(_EPILOGUE[2], "")], False),
    "no epilogue": ([(line, "") for line in _EPILOGUE], False),
    "no heads": ([("    if (HEADS && head) heads(", "    if (false) heads(")], False),
    "elu with __expf": ([(_ELU, _ELU.replace("expf", "__expf"))], False),
    "elu as a select": ([(_ELU, "case 1: return z > 0.f ? z : expf(fminf(z, 0.f)) - 1.f;")], False),
    "one warpgroup a block": ([("return per_sm == 1 ? 4 : 2;", "return 1;")], False),
    "streamed, never resident": ([("      if (pass == 0 && fit >= per_tile) return per_tile;",
                                   "      if (false) return per_tile;")], True),
}


def _build(name: str, subs) -> tuple[subprocess.Popen, Path]:
    """Starts ``nvcc`` on the variant's copy of the sources."""
    from cusrl_tpu_torch.nn.kernels import build

    out = build.BUILD_DIR / "probe" / name.replace(" ", "_").replace(",", "")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    files = {f: (build.CSRC_DIR / f).read_text() for f in (*HEADERS, SOURCE)}
    for old, new in subs:
        hits = [f for f, text in files.items() if old in text]
        if len(hits) != 1:
            raise RuntimeError(f"variant {name!r}: the text to replace is in {hits}, not in one file: {old!r}")
        files[hits[0]] = files[hits[0]].replace(old, new)
    for f, text in files.items():
        (out / f).write_text(text)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-o", str(out / "lib.so"), str(out / SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def _load(path: Path) -> ctypes.CDLL:
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    lib = ctypes.CDLL(str(path))
    lib.mlp_chain_fwd.argtypes = [ctypes.POINTER(fm._Params), ctypes.c_int, ctypes.c_void_p]
    lib.mlp_chain_fwd.restype = ctypes.c_int
    lib.mlp_chain_error_string.argtypes = [ctypes.c_int]
    lib.mlp_chain_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def _variant(lib, streamed: bool):
    """The wrapper launches ``lib``, and with ``streamed`` allocates a pack
    buffer for every chain (the variant's plan streams every chain)."""
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.nn.kernels import weight_images as wi

    library, plan = fm._library, wi.chain_plan

    def streamed_plan(dims, rows, chains, sms):
        return {**plan(dims, rows, chains, sms), "resident": 0}

    fm._library = lambda stem: lib
    if streamed:
        wi.chain_plan = streamed_plan
    try:
        yield
    finally:
        fm._library, wi.chain_plan = library, plan


def _device_ms(fn, repeats: int = 10, warmup: int = 3) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for event in prof.key_averages():
        if "mlpf::" in event.key:
            us = getattr(event, "self_device_time_total", 0) or getattr(event, "self_cuda_time_total", 0)
            total += us / event.count / 1e3
    return total


def _host_us(fn, calls: int = 200) -> float:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - start) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _shapes(device) -> dict:
    """The zoo's shapes (chip_smoke.py's), with random weights from seed 0."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(0)

    def params(widths):
        ws = [(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device) for a, b in zip(widths, widths[1:])]
        return ws, [(torch.randn(b, generator=gen) * 0.1).to(device) for b in widths[1:]]

    (wa, ba), (wc, bc) = params((48, 512, 256, 128)), params((48, 512, 256, 128))
    (wh, bh), (wf, bf) = params((128, 128)), params((128, 512, 128))
    heads = [((torch.randn(d, 128, generator=gen) * 0.2).to(device), (torch.randn(d, generator=gen) * 0.1).to(device))
             for d in (12, 1)]
    x98 = torch.tanh(torch.randn(98304, 48, generator=gen)).to(device)
    x24 = [torch.tanh(torch.randn(24576, 48, generator=gen)).to(device) for _ in range(2)]
    xh, xh1, xf1 = (torch.randn(rows, 128, generator=gen).to(device, torch.bfloat16) for rows in (262144, 1024, 1024))
    return {
        "K1f 98,304": lambda: fm._launch_fwd([x98], [wa], [ba], "elu", True, False, "K1f"),
        "K2f 2 x 24,576 saving": lambda: fm._launch_fwd(x24, [wa, wc], [ba, bc], "elu", True, True, "K2f"),
        "K8f 2 x 24,576": lambda: fm._launch_fwd(x24, [wa, wc], [ba, bc], "elu", True, False, "K8f", heads=heads),
        "head 262,144": lambda: fm._launch_fwd([xh], [wh], [bh], "elu", True, False, "K1f"),
        "head 1,024": lambda: fm._launch_fwd([xh1], [wh], [bh], "elu", True, False, "K1f"),
        "gelu FFN 1,024": lambda: fm._launch_fwd([xf1], [wf], [bf], "gelu", False, False, "K1f"),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_chain_forward: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    start = time.perf_counter()
    builds = {name: _build(name, subs) for name, (subs, _) in VARIANTS.items()}
    for name, (proc, _) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name!r} failed to build:\n{log}", file=sys.stderr)
            return 1
    print(f"[build] {len(builds)} variants in {time.perf_counter() - start:.1f} s")
    shapes = _shapes(torch.device("cuda", 0))
    print("device ms per call (chain + pack): " + " | ".join(shapes) + "; host us per call, head 1,024")
    for name, (_, out) in builds.items():
        with _variant(_load(out / "lib.so"), VARIANTS[name][1]):
            device = [_device_ms(fn) for fn in shapes.values()]
            host = _host_us(shapes["head 1,024"])
        print(f"  {name:26s} " + " | ".join(f"{ms:.4f}" for ms in device) + f"; {host:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
