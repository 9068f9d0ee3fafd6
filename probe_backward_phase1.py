#!/usr/bin/env python3
"""Phase 1 of the redesigned backwards on the card, by kernel name, and
where its time goes.

Run from the root of a checkout on a machine with a card:

    python3 probe_backward_phase1.py [--variants]

For each backward whose phase 1 runs on wgmma (the fused block's pre and
post backwards, ``fbp::`` and ``fbb::``; the MLP chain backward, ``mlpb::``;
the single-launch PPO step, ``mlpm::``, whose phase 1 runs the forward too)
at the main paths' shapes it prints the device time per call of every kernel of the launch
(``torch.profiler``, mean of 10 calls after 3), phase 1's sum (the pack and
the persistent kernel) and phase 2's, on random inputs from a fixed seed.
With ``--variants`` it builds copies of ``csrc/fused_block.cu`` and
``csrc/mlp_chain_bwd.cu`` with one part taken out or done another way
(``VARIANTS``: textual substitutions, one ``nvcc`` each, all at once, into
``cusrl_tpu_torch/_build/probe/``) and prints phase 1's device ms of each on
the cases of its kernel (a variant's name starts with ``pre``, ``post`` or
``chain``).
With ``--phase2`` it builds copies of both sources with a changed
``csrc/dw_phase2.cuh`` instead (``PHASE2_VARIANTS``) and prints phase 2's
device ms of every case for each.
Nothing is checked here (a variant that takes a part out gives other
outputs): ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py`` hold the
kernels against their plain versions.
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
MLP = (48, 512, 256, 128)
FFN = (128, 512, 128)
HEAD = (128, 128)
HEADERS = ("hopper_wg.cuh", "mlp_chain.cuh", "dw_phase2.cuh")
# name: (source, substitutions); each substitution replaces every occurrence in the source.
VARIANTS = {
    "pre: one gqkv tile": ("fused_block.cu", [(
        "BLOCKS_PER_SM = 1, GQKV_TILES = 2,", "BLOCKS_PER_SM = 1, GQKV_TILES = 1,")]),
    "pre: two blocks per SM, one gqkv tile each, images streamed": ("fused_block.cu", [(
        "BLOCKS_PER_SM = 1, GQKV_TILES = 2,", "BLOCKS_PER_SM = 2, GQKV_TILES = 1,")]),
    "pre: no column sums": ("fused_block.cu", [
        ("col_rs([&]", "if (false) col_rs([&]"),
        ("      wg::col_combine<NA, SETS>(", "      if (false) wg::col_combine<NA, SETS>(")]),
    "pre: column partials by three shuffle rounds": ("fused_block.cu", [("col_rs([&]", "wg::col_partials<NA>([&]")]),
    "post: no column sums": ("fused_block.cu", [("wg::col_sums<NA", "if (false) wg::col_sums<NA")]),
    "post: no act'": ("fused_block.cu", [("mlp::mul_act_grad(d, [&](int i) { return wg::pair_at(sv, i); }, act);", "")]),
    "post: saved loads after the product": ("fused_block.cu", [(
        "        // The loads fly during the ring's wait and the product.\n"
        "        wg::load_pairs<NA>(saved, F, c0 + cw, ccols, row0, n_rows, f, sv);\n        wg::zero(d);\n        wg::issue(d, wg::smem_u32(ta), E, ring, b_off);\n"
        "        wg::finish(d, ring);\n",
        "        wg::zero(d);\n        wg::issue(d, wg::smem_u32(ta), E, ring, b_off);\n        wg::finish(d, ring);\n"
        "        wg::load_pairs<NA>(saved, F, c0 + cw, ccols, row0, n_rows, f, sv);\n")]),
    "chain: saved loads after the issue": ("mlp_chain_bwd.cu", [(
        "      if (l > 0) wg::load_pairs<NA>(static_cast<const bf16*>(c.h[l - 1]), N, c0, cols, row0, n_rows, f, sv);\n"
        "      wg::zero(d);\n      wg::issue(d, a_in, K, ring, b_off);",
        "      wg::zero(d);\n      wg::issue(d, a_in, K, ring, b_off);\n"
        "      if (l > 0) wg::load_pairs<NA>(static_cast<const bf16*>(c.h[l - 1]), N, c0, cols, row0, n_rows, f, sv);")]),
    "chain: no column sums": ("mlp_chain_bwd.cu", [("wg::col_sums<NA>(", "if (false) wg::col_sums<NA>(")]),
    "chain: no act'": ("mlp_chain_bwd.cu", [("if (has_act(p, l)) mlp::mul_act_grad(", "if (false) mlp::mul_act_grad(")]),
    "chain: no head partials": ("mlp_chain_bwd.cu", [("  for (int q = t; q < (dim + 3) / 4 * latent; q += NT) {",
                                                      "  for (int q = t; false; q += NT) {")]),
    "chain: no head top d": ("mlp_chain_bwd.cu", [("for (int o = 0; o < hd.dim; ++o) {", "for (int o = 0; o < 0; ++o) {")]),
    "chain: one block of four warpgroups per SM": ("mlp_chain_bwd.cu", [(
        "L.tiles * num_chains <= out.sms, L.per_sm);", "true, L.per_sm);")]),
    "chain: the heads' top act' from device memory": ("mlp_chain_bwd.cu", [(
        "wg::tile_pairs<NA>(lat, c0, cols, f, sv);  // the latent, already in its tile",
        "wg::load_pairs<NA>(static_cast<const bf16*>(c.h[num_layers - 1]), top, c0, cols, row0, n_rows, f, sv);")]),
}

# Phase 2's variants: substitutions in dw_phase2.cuh, built into both sources that include it.
PHASE2_VARIANTS = {
    "phase2: the forward's tanhf gelu": [("return __float2bfloat16(__fdividef(z, 1.f + __expf(-2.f * u)));",
                                          "return __float2bfloat16(0.5f * z * (1.f + tanhf(u)));")],
    "phase2: gelu with one MUFU op (a Newton reciprocal)": [(
        "return __float2bfloat16(__fdividef(z, 1.f + __expf(-2.f * u)));",
        "const float d = 1.f + __expf(fminf(-2.f * u, 80.f));\n"
        "  float r = __int_as_float(0x7EF311C3 - __float_as_int(d));\n"
        "  r = r * (2.f - d * r);\n  r = r * (2.f - d * r);\n  r = r * (2.f - d * r);\n"
        "  return __float2bfloat16(z * r);")],
    "phase2: no H conversion": [("const bool convert = T.kind != H_BF16;", "const bool convert = false;")],
    "phase2: no products": [("    if (active) {\n      wg::wgmma_fence();", "    if (false) {\n      wg::wgmma_fence();")],
    "phase2: no column sums": [("cols[q] = q0 + q < p.col_floats[chain] ? column_sum(p, chain, q0 + q, r0, r1) : 0.f;",
                                "cols[q] = 0.f;")],
    "phase2: no split reduction": [("  cluster_sync();  // every block of the cluster holds its partial", "  return;")],
    "phase2: a 160 KB ring": [("constexpr int MAX_RING = 224 * 1024; ", "constexpr int MAX_RING = 160 * 1024; ")],
}


def _cases(torch, device):
    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(0)

    def w(out, inp):
        return (torch.randn(out, inp, generator=gen) / math.sqrt(inp)).to(device)

    def v(n, base=0.0):
        return (base + torch.randn(n, generator=gen) * 0.1).to(device)

    def chain(widths, rows, chains, activation="elu", trailing=True):
        wss = [[w(b, a) for a, b in zip(widths[:-1], widths[1:])] for _ in range(chains)]
        bss = [[v(b) for b in widths[1:]] for _ in range(chains)]
        xs = [torch.tanh(torch.randn(rows, widths[0], generator=gen)).to(device) for _ in range(chains)]
        gs = [(torch.randn(rows, widths[-1], generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
        hss = []
        for x, ws, bs in zip(xs, wss, bss):
            out, hid = fm.mlp_chain_fwd_plain(x, ws, bs, activation, trailing, True)
            hss.append([*hid, out])
        return xs, gs, wss, hss

    def pre(rows, chains):
        e, i = 128, 48
        args = [[], [], [], [], []]
        for _ in range(chains):
            ps = (w(e, i), v(e), v(e, 1.0), v(e), w(e, e), w(e, e), w(e, e), v(e), v(e), v(e))
            x = torch.tanh(torch.randn(rows, i, generator=gen)).to(device)
            h = fb.pre_fwd_plain(x, *ps)[0]
            gh = (torch.randn(rows, e, generator=gen) * 0.01).to(device)
            gqkv = (torch.randn(rows, 3 * e, generator=gen) * 0.01).to(device, torch.bfloat16)
            for a, t in zip(args, (x, h, gh, gqkv, ps)):
                a.append(t)
        return lambda: fb._launch_pre_bwd(*args, True, fb._counter("pre_b", chains))

    def post(rows, chains):
        e, f = 128, 512
        args = [[], [], [], [], []]
        for _ in range(chains):
            ps = (w(e, e), v(e), v(e, 1.0), v(e), w(f, e), v(f), w(e, f), v(e))
            attn = torch.randn(rows, e, generator=gen).to(device)
            h = torch.randn(rows, e, generator=gen).to(device, torch.bfloat16).float()
            _, r1, saved = fb.post_fwd_plain(attn, h, *ps, "gelu", True)
            g = (torch.randn(rows, e, generator=gen) * 0.01).to(device, torch.bfloat16)
            for a, t in zip(args, (attn, g, r1, saved, (ps[0], ps[4], ps[6], ps[2], ps[3]))):
                a.append(t)
        return lambda: fb._launch_post_bwd(*args, "gelu", fb._counter("post_b", chains))

    cases = {}
    for rows, chains in ((65536, 1), (6144, 1), (6144, 2)):
        cases[f"K{4 if chains == 1 else 5} pre b {chains} x {rows}"] = pre(rows, chains)
    for rows, chains in ((65536, 1), (6144, 1), (6144, 2)):
        cases[f"K{4 if chains == 1 else 5} post b {chains} x {rows}"] = post(rows, chains)
    xs, gs, wss, hss = chain(MLP, 24576, 2)
    cases["K2b 2 x 24576"] = lambda: fm._launch_bwd(xs, gs, wss, hss, "elu", True, True, "K2b")
    heads = [(w(d, 128) * 0.2, None, (torch.randn(24576, d, generator=gen) * 0.01).to(device), None) for d in (12, 1)]
    cases["K8b 2 x 24576"] = lambda: fm._launch_bwd(xs, None, wss, hss, "elu", True, True, "K8b", heads=heads)
    (wm, wv), (bm, bv) = (w(12, 128) * 0.2, w(1, 128) * 0.2), (v(12), v(1))
    std = torch.exp(torch.randn(12, generator=gen) * 0.2).to(device)
    with torch.no_grad():
        mean = hss[0][-1].float() @ wm.T + bm
    action = mean + std * torch.randn(24576, 12, generator=gen).to(device)
    old_logp = (-0.5 * ((action - mean) / std).square() - torch.log(std) - 0.9189385332046727).sum(-1)
    loss = (xs, hss, wss, wm, bm, wv, bv, std, action, old_logp, torch.randn(24576, generator=gen).to(device),
            torch.randn(24576, 1, generator=gen).to(device), torch.randn(24576, 1, generator=gen).to(device), 0.2, 1.0,
            0.5, None, "elu", True)
    cases["K9s 2 x 24576"] = lambda: fp._loss_bwd(*loss)
    bss = [[v(b) for b in MLP[1:]] for _ in range(2)]
    cases["K9m 2 x 24576"] = lambda: fp._ppo_step(xs, bss, wss, *loss[3:])[:2]
    x1, g1, w1, h1 = chain(MLP, 24576, 1)
    cases["K1b ELU dX 24576"] = lambda: fm._launch_bwd(x1, g1, w1, h1, "elu", True, False, "K1b")
    xh, gh, wh, hh = chain(HEAD, 65536, 1)
    cases["K1b TL head 65536"] = lambda: fm._launch_bwd(xh, gh, wh, hh, "elu", True, False, "K1b")
    xf, gf, wf, hf = chain(FFN, 6144, 1, "gelu", False)
    cases["K1b gelu FFN 6144"] = lambda: fm._launch_bwd(xf, gf, wf, hf, "gelu", False, False, "K1b")
    return cases


KERNELS = {"pre": "3fbp14pre_bwd_kernel", "post": "3fbb15post_bwd_kernel", "chain": "chain_bwd_kernel",
           "step": "ppo_step_kernel"}


def _usage(log: str, symbol: str) -> str:
    """Registers, spills and wgmma serialization (C7515) of the kernels
    whose mangled names hold ``symbol``, from a build's ptxas log."""
    found, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and symbol in name and ("registers" in line or "spill stores" in line):
            found.append(line.split(":", 1)[-1].strip())
    serial = sum("C7515" in line and symbol in line for line in log.splitlines())
    return "; ".join(found) + (f"; C7515 x{serial}" if serial else "")


def _build(name: str, source: str, subs, edited: str | None = None) -> tuple[subprocess.Popen, Path]:
    """Starts ``nvcc`` on the variant's copy of the sources: ``subs`` made
    in ``edited`` (by default ``source``), the library built from
    ``source``."""
    from cusrl_tpu_torch.nn.kernels import build

    edited = edited or source
    out = build.BUILD_DIR / "probe" / "".join(ch if ch.isalnum() else "_" for ch in name + "_" + source)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    files = {f: (build.CSRC_DIR / f).read_text() for f in (*HEADERS, source)}
    for old, new in subs:
        if old not in files[edited]:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {edited}")
        files[edited] = files[edited].replace(old, new)
    for f, text in files.items():
        (out / f).write_text(text)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-o", str(out / "lib.so"), str(out / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


@contextlib.contextmanager
def _variant(stem: str, path: Path, more: dict | None = None):
    """The wrappers load ``path`` for ``csrc/<stem>.cu`` (and each path of
    ``more`` for its stem), configured as their own libraries."""
    from cusrl_tpu_torch.nn.kernels import build

    load = build.load_library
    libs = {s: ctypes.CDLL(str(p)) for s, p in {stem: path, **(more or {})}.items()}
    build.load_library = lambda s: libs[s] if s in libs else load(s)
    try:
        yield
    finally:
        build.load_library = load


def _phase_ms(chip_smoke, fn) -> tuple[float, float, str]:
    found = chip_smoke._profiled_kernels(fn, ("dw", "mlpb", "fbb", "fbp", "mlpm"), 10, 3)[0]
    phase1 = [k for k in found if not chip_smoke._in_namespaces(k[0], ("dw",))]
    phase2 = [k for k in found if chip_smoke._in_namespaces(k[0], ("dw",))]
    ms = [sum(us / count for _, count, us in phase) / 1e3 for phase in (phase1, phase2)]
    kernels = "; ".join(f"{k.split('(')[0].replace('void ', '')} {us / count / 1e3:.4f} ({count})"
                        for k, count, us in phase1)
    return ms[0], ms[1], kernels


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_backward_phase1: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from cusrl_tpu_torch.nn.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    start = time.perf_counter()
    if "--phase2" in argv:
        return _phase2_variants(chip_smoke, torch, start)
    builds = {name: _build(name, source, subs) for name, (source, subs) in VARIANTS.items()} if argv else {}
    build.build_all()
    usage = {}
    for name, (proc, _) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name!r} failed to build:\n{log}", file=sys.stderr)
            return 1
        usage[name] = _usage(log, KERNELS[name.split(":")[0]])
    print(f"[build] {time.perf_counter() - start:.1f} s, {len(builds)} variants")
    for kind, symbol in KERNELS.items():
        stem = "mlp_chain_bwd" if kind in ("chain", "step") else "fused_block"
        print(f"  {kind}: {_usage((build.BUILD_DIR / f'{stem}.log').read_text(), symbol)}")
    cases = _cases(torch, torch.device("cuda", 0))
    for name, fn in cases.items():
        p1, p2, kernels = _phase_ms(chip_smoke, fn)
        print(f"{name:22s} phase1_ms={p1:.4f} phase2_ms={p2:.4f}  [{kernels}]")
    for name, (_, out) in builds.items():
        stem = VARIANTS[name][0][:-3]
        with _variant(stem, out / "lib.so"):
            kind = name.split(":")[0]  # pre, post or chain
            times = [f"{case} {_phase_ms(chip_smoke, fn)[0]:.4f}" for case, fn in cases.items()
                     if (f" {kind} b " in case) or (kind == "chain" and " b " not in case)]
        print(f"  {name:36s} phase1_ms: " + " | ".join(times) + f"  [{usage[name]}]")
    return 0


def _phase2_variants(chip_smoke, torch, start: float) -> int:
    """Phase 2's device ms of every case, as built and with each of
    ``PHASE2_VARIANTS``."""
    from cusrl_tpu_torch.nn.kernels import build

    stems = ("fused_block", "mlp_chain_bwd")
    builds = {(name, stem): _build(name, stem + ".cu", subs, "dw_phase2.cuh")
              for name, subs in PHASE2_VARIANTS.items() for stem in stems}
    build.build_all()
    for key, (proc, _) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {key} failed to build:\n{log}", file=sys.stderr)
            return 1
    print(f"[build] {time.perf_counter() - start:.1f} s, {len(PHASE2_VARIANTS)} phase-2 variants")
    cases = _cases(torch, torch.device("cuda", 0))
    print("  as built: " + " | ".join(f"{case} {_phase_ms(chip_smoke, fn)[1]:.4f}" for case, fn in cases.items()))
    for name in PHASE2_VARIANTS:
        paths = {stem: builds[name, stem][1] / "lib.so" for stem in stems}
        with _variant("fused_block", paths["fused_block"], {"mlp_chain_bwd": paths["mlp_chain_bwd"]}):
            times = [f"{case} {_phase_ms(chip_smoke, fn)[1]:.4f}" for case, fn in cases.items()]
        print(f"  {name}: phase2_ms " + " | ".join(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
