"""Phase 2 of the backward kernels on the CPU: its plan (the split of the
rows over blocks and clusters, ``nn/kernels/dw_phase2.py``), the scratch the
wrappers allocate for it, the kinds of H they name, and a plain phase 2 (dW
= D^T H over bf16 values, the column sums of phase 1's partials) against the
JAX backward's weight and bias gradients.  No kernel is built here; the
kernels themselves are checked on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``)."""

import ctypes

import numpy as np
import pytest
import torch

from cusrl_tpu_torch.nn.kernels import dw_phase2 as dw
from cusrl_tpu_torch.nn.kernels import fused_block as fb
from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

ROWS = (1, 63, 64, 65, 255, 6_144, 6_145, 24_576, 24_577, 65_536, 65_537)
B, F32, SAVED = dw.H_BF16, dw.H_F32, dw.H_SAVED
# The backwards of PERF.md's phase table: (dW shapes [(n_out, n_in)], rows per
# chain, chains, each job's kind of H: bf16, fp32, or a saved gelu
# pre-activation).  K4/K5 pre: W_in 48 -> 128 and W_q, W_k, W_v; post: W_o
# (on the fp32 attention), the FFN's 512 up and its gelu down.
TABLE = {
    "K1b gelu FFN": ([(512, 128), (128, 512)], 6_144, 1, [B, SAVED]),
    "K1b ELU 48-512-256-128": ([(512, 48), (256, 512), (128, 256)], 24_576, 1, [F32, B, B]),
    "K1b IL 240-512-256-128": ([(512, 240), (256, 512), (128, 256)], 24_576, 1, [F32, B, B]),
    "K1b TL head": ([(128, 128)], 65_536, 1, [F32]),
    "K1b R head": ([(128, 256)], 6_144, 1, [F32]),
    "K1b AMP relu 48-512-256": ([(512, 48), (256, 512)], 4_096, 1, [F32, B]),
    "K2b RJ pair": ([(128, 256)], 6_144, 2, [F32]),
    "K2b F pair": ([(128, 48), (128, 128), (128, 128)], 24_576, 2, [F32, B, B]),
    "K2b K8b K9s K9m": ([(512, 48), (256, 512), (128, 256)], 24_576, 2, [F32, B, B]),
    "K4 pre b": ([(128, 48)] + [(128, 128)] * 3, 65_536, 1, [F32, B, B, B]),
    "K4 post b": ([(128, 128), (512, 128), (128, 512)], 65_536, 1, [F32, B, SAVED]),
    "K4 post b TF": ([(128, 128), (512, 128), (128, 512)], 6_144, 1, [F32, B, SAVED]),
    "K5 pre b": ([(128, 48)] + [(128, 128)] * 3, 6_144, 2, [F32, B, B, B]),
    "K5 post b": ([(128, 128), (512, 128), (128, 512)], 6_144, 2, [F32, B, SAVED]),
}
# The plan at the table's shapes: (dW tiles per chain, splits, cluster).
PLANS = {
    "K1b gelu FFN": (8, 12, 4), "K1b ELU 48-512-256-128": (9, 12, 4), "K1b IL 240-512-256-128": (13, 8, 8),
    "K1b TL head": (1, 120, 8), "K1b R head": (2, 24, 8), "K1b AMP relu 48-512-256": (8, 12, 4),
    "K2b RJ pair": (2, 24, 8), "K2b F pair": (3, 20, 4), "K2b K8b K9s K9m": (9, 6, 2), "K4 pre b": (4, 28, 4),
    "K4 post b": (9, 12, 4), "K4 post b TF": (9, 12, 4), "K5 pre b": (4, 12, 4), "K5 post b": (9, 6, 2),
}
JOBS = {name: (dw.dw_tile_count(shapes, kinds), chains) for name, (shapes, _, chains, kinds) in TABLE.items()}


def _row_tiles(rows):
    return -(-rows // dw.ROW_TILE)


def split_ranges(row_tiles, splits):
    """The row tiles of each split as ``dw::phase2_kernel`` reads them."""
    return [dw.split_range(row_tiles, splits, s) for s in range(splits)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("job", sorted(JOBS))
def test_splits_cover_every_row_tile_once_in_order(rows, job):
    row_tiles = _row_tiles(rows)
    splits, cluster = dw.dw_row_splits(row_tiles, *JOBS[job])
    ranges = split_ranges(row_tiles, splits)
    assert len(ranges) == splits >= 1
    covered = [t for r in ranges for t in r]
    assert covered == list(range(row_tiles))  # each tile once, contiguous, in order
    sizes = [len(r) for r in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if row_tiles >= dw.MIN_TILES_PER_SPLIT:
        assert min(sizes) >= dw.MIN_TILES_PER_SPLIT
    assert cluster in (1, 2, 4, 8) and splits % cluster == 0
    dw_tiles, chains = JOBS[job]
    blocks = splits * dw_tiles * chains
    # One wave in such clusters: no more blocks than it holds, unless the tiles alone are more.
    assert blocks <= max(dw.WAVE[cluster], dw_tiles * chains)
    best = max(max(1, min(dw.WAVE[c] // (dw_tiles * chains), row_tiles // dw.MIN_TILES_PER_SPLIT)) // c * c
               for c in (1, 2, 4, 8))
    assert 4 * splits >= 3 * best  # the cluster's rounding keeps three quarters of the most splits


def test_same_shape_gives_the_same_splits():
    first = {(r, j): dw.dw_row_splits(_row_tiles(r), *JOBS[j]) for r in ROWS for j in JOBS}
    for (r, j), value in reversed(list(first.items())):
        assert dw.dw_row_splits(_row_tiles(r), *JOBS[j]) == value


@pytest.mark.parametrize("job", sorted(JOBS))
def test_one_split_for_a_single_row_tile(job):
    assert dw.dw_row_splits(1, *JOBS[job]) == (1, 1)
    assert split_ranges(1, 1) == [range(0, 1)]


def test_main_path_splits():
    """The splits at the paths' shapes: TL's head (one tile) takes the most."""
    assert dw.dw_row_splits(_row_tiles(65_536), 1, 1) == (120, 8)
    assert dw.dw_row_splits(_row_tiles(65_536), 9, 1) == (12, 4)
    assert dw.dw_row_splits(_row_tiles(24_576), 9, 2) == (6, 2)
    assert dw.dw_row_splits(_row_tiles(65_537), 9, 1) == (12, 4)
    assert split_ranges(_row_tiles(65_537), 12)[-1] == range(939, 1025)  # 86 row tiles, the others 85 or 86


@pytest.mark.parametrize("name", sorted(TABLE))
def test_plan_at_the_table_shapes(name):
    """The plan of every backward in PERF.md's phase table: tiles, splits,
    cluster, the scratch (none where one cluster holds a tile's splits) and
    the column chunk."""
    shapes, rows, chains, kinds = TABLE[name]
    tiles, splits, cluster = PLANS[name]
    assert dw.dw_tile_count(shapes, kinds) == tiles
    assert dw.dw_row_splits(_row_tiles(rows), tiles, chains) == (splits, cluster)
    cols = [sum(o for o, _ in shapes)] * chains
    chunk = dw.col_chunk(cols, tiles)
    assert chunk % dw.COL_ALIGN == 0 and tiles * chunk >= cols[0] and (tiles * (chunk - dw.COL_ALIGN) < cols[0])
    shape = dw.scratch_shapes(tiles, chains, splits, cluster, chunk)
    assert shape == (None if splits == cluster else (chains, tiles, splits // cluster, 128 * 256 + chunk))
    s, tensors = dw.make_scratch(shapes, cols, rows, "cpu", kinds)
    assert (s.splits, s.cluster, s.tiles, s.col_chunk) == (splits, cluster, tiles, chunk)
    assert list(s.kinds)[:len(kinds)] == kinds
    if shape is None:
        assert tensors == [] and not s.partials and not s.counters
    else:
        partials, counters = tensors
        assert tuple(partials.shape) == shape and partials.dtype == torch.float32
        assert counters.dtype == torch.int32 and counters.numel() >= chains * tiles * cluster
        assert not counters.any() and s.counters == counters.data_ptr()


def test_split_policy_refuses_empty_work():
    for args in ((0, 4, 1), (4, 0, 1), (4, 4, 0)):
        with pytest.raises(ValueError):
            dw.dw_row_splits(*args)


@pytest.mark.parametrize("shapes, kinds", [
    ([(128, 48), (128, 128)], [B]),  # a job without its kind
    ([(128, 48)], [B, B]),  # a kind without its job
    ([(128, 48), (128, 128)], [B, 3]),  # no such kind
    ([(128, 48)], [-1]),
    ([(16, 16)] * 9, [B] * 9),  # more jobs than a launch takes
], ids=["few", "many", "unknown", "negative", "nine jobs"])
def test_scratch_refuses_kinds_that_do_not_name_each_job(shapes, kinds):
    with pytest.raises(ValueError):
        dw.make_scratch(shapes, [256], 1_000, "cpu", kinds)


def test_scratch_shapes_and_struct():
    shapes = [(128, 48), (128, 128), (128, 128), (128, 128)]
    assert dw.dw_tile_count(shapes) == dw.dw_tile_count(shapes, [F32]) == 4
    assert dw.dw_tile_count([(512, 240), (16, 16)]) == 5 and dw.dw_tile_count([(512, 240), (16, 16)], [F32]) == 9
    assert dw.dw_tile_count([(256, 512), (16, 16)], [B, SAVED]) == 5
    assert dw.dw_tile_count([(128, 512), (128, 512)], [B, SAVED]) == 6  # a gelu H: 128-wide tiles
    assert dw.scratch_shapes(4, 2, 16, 8, 96) == (2, 4, 2, 128 * 256 + 96)
    assert dw.scratch_shapes(4, 2, 8, 8, 96) is None
    s, tensors = dw.make_scratch(shapes, [768, 700], 65_537, "cpu", [F32, B, B, B])
    splits, cluster = dw.dw_row_splits(_row_tiles(65_537), 4, 2)
    assert (s.splits, s.cluster, s.tiles, s.col_chunk) == (splits, cluster, 4, 192)
    assert list(s.kinds) == [F32, B, B, B, 0, 0, 0, 0]
    partials, counters = tensors
    assert tuple(partials.shape) == (2, 4, splits // cluster, 128 * 256 + 192)
    assert s.partials == partials.data_ptr() and s.counters == counters.data_ptr()
    # The semaphores are shared by the launches of one stream (each leaves them at 0).
    assert dw.make_scratch(shapes, [768, 700], 65_537, "cpu", [F32, B, B, B])[1][1] is counters
    # The ctypes mirror of DwScratch: two pointers, four ints, then a kind per job.
    assert ctypes.sizeof(dw.DwScratch) == 2 * ctypes.sizeof(ctypes.c_void_p) + (4 + dw.MAX_JOBS) * 4


def _mlp_inputs(rng, rows, dims, chains):
    xs = [torch.from_numpy(rng.standard_normal((rows, dims[0])).astype(np.float32)) for _ in range(chains)]
    wss = [[torch.from_numpy(rng.standard_normal((b, a)).astype(np.float32)) for a, b in zip(dims, dims[1:])]
           for _ in range(chains)]
    hss = [[torch.zeros(rows, d, dtype=torch.bfloat16) for d in dims[1:]] for _ in range(chains)]
    return xs, wss, hss


@pytest.mark.parametrize("heads", [None, "heads", "loss"])
def test_mlp_wrapper_allocates_phase2_scratch(heads):
    """``_bwd_params`` (K1b/K2b, K8b, K9s): the jobs are the layers and the
    column sums every layer's db plus each head's partials."""
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    rng = np.random.default_rng(0)
    dims, rows = (48, 64, 32), 1_000
    xs, wss, hss = _mlp_inputs(rng, rows, dims, 2)
    gs = [torch.zeros(rows, dims[-1], dtype=torch.bfloat16) for _ in range(2)]
    head_spec, loss = None, None
    a_dim, v_dim = 6, 1
    if heads is not None:
        wm, wv = torch.zeros(a_dim, dims[-1]), torch.zeros(v_dim, dims[-1])
        g = None if heads == "loss" else torch.zeros(rows, a_dim)
        head_spec = [(wm, torch.zeros(a_dim), g, None), (wv, torch.zeros(v_dim), None if g is None else
                                                         torch.zeros(rows, v_dim), None)]
        if heads == "loss":
            loss = fp._loss_args(xs, wm, wv, torch.ones(a_dim), torch.zeros(rows, a_dim), torch.zeros(rows),
                                 torch.zeros(rows), None, torch.zeros(rows, v_dim), 0.2, 1.0, 0.5, None)
    _, phase2, _, _ = fm._bwd_params(xs, None if heads else gs, wss, hss, "elu", True, True, head_spec, loss)
    tiles = dw.dw_tile_count([(64, 48), (32, 64)], [F32, B])
    assert tiles == 2
    splits, cluster = dw.dw_row_splits(_row_tiles(rows), tiles, 2)
    assert (phase2.splits, phase2.cluster, phase2.tiles) == (splits, cluster, tiles)
    strides = [0, 0]
    if heads is not None:
        strides = [a_dim * 32 + a_dim, v_dim * 32 + v_dim]
        if heads == "loss":
            strides = [strides[0] + 2 + a_dim, strides[1] + 2]
    assert phase2.col_chunk == dw.col_chunk([64 + 32 + strides[0], 64 + 32 + strides[1]], tiles)


@pytest.mark.parametrize("op", ["pre", "post"])
def test_block_wrappers_allocate_phase2_scratch(op, monkeypatch):
    """``_launch_pre_bwd`` / ``_launch_post_bwd`` hand phase 2 a scratch of
    the right shapes (the launch itself is intercepted: no card here)."""
    seen = {}
    monkeypatch.setattr(fb, "_launch", lambda entry, counter, p, chains, device, phase2=None: seen.update(
        entry=entry, chains=chains, phase2=phase2))
    rng = np.random.default_rng(1)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rows, e, f, i = 300, 32, 64, 16
    if op == "pre":
        ps = (t(e, i), t(e), t(e), t(e), t(e, e), t(e, e), t(e, e), t(e), t(e), t(e))
        fb._launch_pre_bwd([t(rows, i)] * 2, [t(rows, e)] * 2, [None] * 2, [t(rows, 3 * e)] * 2, [ps] * 2, True,
                           "K5pre_b")
        dw_floats, cols, tiles = e * i + 3 * e * e, 6 * e, dw.dw_tile_count([(e, i)] + [(e, e)] * 3, [F32])
    else:
        ws = (t(e, e), t(f, e), t(e, f), t(e), t(e))
        bf = lambda *shape: t(*shape).to(torch.bfloat16)
        fb._launch_post_bwd([t(rows, e)] * 2, [bf(rows, e)] * 2, [bf(rows, e)] * 2, [bf(rows, f)] * 2, [ws] * 2,
                            "gelu", "K5post_b")
        dw_floats, cols, tiles = e * e + 2 * e * f, 4 * e + f, dw.dw_tile_count([(e, e), (f, e), (e, f)],
                                                                                 [F32, B, SAVED])
    s = seen["phase2"]
    assert seen["entry"] == f"fused_block_{op}_bwd" and seen["chains"] == 2
    assert (s.splits, s.cluster, s.tiles) == (*dw.dw_row_splits(_row_tiles(rows), tiles, 2), tiles)
    assert dw_floats > 0 and s.col_chunk == dw.col_chunk([cols, cols], tiles)


# -- The plain phase 2 against the JAX backward's weight gradients ------------

JAX_ROWS = 1_000  # 16 row tiles, the last one ragged
# The phase table's chains: the MLP pair's actor (ELU, fp32 input: an fp32 H),
# the transformer's gelu FFN (a saved pre-activation: H = bf16(gelu(z))), and
# the post block at TF's widths (K4 post b: W_o on the fp32 attention, W_up on
# the bf16 LayerNorm output, W_down on the saved gelu pre-activation).
JAX_CHAINS = {"elu 48-512-256-128": ((48, 512, 256, 128), "elu", True),
              "gelu 128-512-128": ((128, 512, 128), "gelu", False)}
POST_CHAIN, POST_EMBED, POST_FF = "K4 post 128-512 gelu", 128, 512
JAX_CASES = [(name, layer) for name, (dims, _, _) in JAX_CHAINS.items() for layer in range(len(dims) - 1)]
JAX_CASES += [(POST_CHAIN, job) for job in range(3)]


def _row_tile_sums(d: torch.Tensor) -> torch.Tensor:
    """The fp32 column partials of ``d`` per 64-row tile, as phase 1 writes them."""
    d = torch.nn.functional.pad(d.float(), (0, 0, 0, -d.shape[0] % dw.ROW_TILE))
    return d.view(-1, dw.ROW_TILE, d.shape[1]).sum(1)


def _mlp_phase1(x, g, ws, hs, activation, trailing):
    """What phase 1 hands phase 2 for each layer of an MLP chain, by the
    port's plain chain backward: ``(D bf16 [N, out], H as stored, its kind,
    the column partials of d per row tile)``."""
    jobs = {}
    d = g.float()
    for layer in reversed(range(len(ws))):
        if layer < len(ws) - 1 or trailing:
            d = d * fm._dact_plain(activation, hs[layer].float())
        d_bf = d.to(torch.bfloat16)
        if layer == 0:
            h, kind = x, F32
        else:
            h, kind = hs[layer - 1], SAVED if activation == "gelu" else B
        jobs[layer] = (d_bf, h, kind, _row_tile_sums(d))
        d = d_bf.float() @ ws[layer].to(torch.bfloat16).float()
    return [jobs[layer] for layer in range(len(ws))]


def _post_phase1(attn, g, r1, saved, w_o, w_up, w_down, g2, bb2):
    """The same for the post block's three weight gradients (W_o, W_up,
    W_down), by the port's plain post backward (``fused_block.post_bwd_plain``)
    under gelu."""
    bf = lambda t: t.to(torch.bfloat16).float()
    s = saved.float()
    dz1 = (bf(g) @ bf(w_down)) * fm._dact_plain("gelu", s)
    y2, xhat2, inv2 = fb._ln_plain(r1.float(), g2, bb2)
    dr1 = g.float() + fb._ln_bwd_plain(bf(dz1) @ bf(w_up), xhat2, inv2, g2)
    return [(dr1.to(torch.bfloat16), attn, F32, _row_tile_sums(dr1)),
            (dz1.to(torch.bfloat16), y2.to(torch.bfloat16), B, _row_tile_sums(dz1)),
            (g.to(torch.bfloat16), saved, SAVED, _row_tile_sums(g))]


@pytest.fixture(scope="module")
def jax_backwards():
    """One run of a JAX backward per chain (Pallas in interpret mode): the
    MLP chains' ``_run_bwd`` from the port's own forward and a bf16
    cotangent, the post block's ``_post_run_bwd`` from JAX's forward's saved
    tensors.  ``{chain: [(D, H, kind, column partials, JAX's dW [out, in],
    JAX's db), ...]}``, a tuple per job."""
    import jax.numpy as jnp

    from cusrl_tpu.nn.kernels import fused_block as jfb
    from cusrl_tpu.nn.kernels import fused_mlp as jfm

    results = {}
    pad = -JAX_ROWS % 64  # the kernels read the saved values at their padded row count
    for seed, (name, (dims, activation, trailing)) in enumerate(JAX_CHAINS.items()):
        rng = np.random.default_rng(40 + seed)
        x = np.tanh(rng.standard_normal((JAX_ROWS, dims[0]))).astype(np.float32)
        ws = [(rng.standard_normal((b, a)) / np.sqrt(a)).astype(np.float32) for a, b in zip(dims, dims[1:])]
        bs = [(rng.standard_normal(b) * 0.1).astype(np.float32) for b in dims[1:]]
        g = (rng.standard_normal((JAX_ROWS, dims[-1])) * 0.1).astype(np.float32)
        tx, tws = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
        out, hid = fm.mlp_chain_fwd_plain(tx, tws, [torch.from_numpy(b) for b in bs], activation, trailing, True)
        hs = [*hid, out]
        tg = torch.from_numpy(g).to(torch.bfloat16)
        jhs = [jnp.asarray(np.pad(h.float().numpy(), ((0, pad), (0, 0)))).astype(jnp.bfloat16) for h in hs]
        _, dws, dbs = jfm._run_bwd(jnp.asarray(x), jnp.asarray(tg.float().numpy()).astype(jnp.bfloat16),
                                   tuple(jnp.asarray(w.T) for w in ws), jhs[:-1], jhs[-1], activation, trailing, 64,
                                   True)
        results[name] = [(*job, np.asarray(w).T, np.asarray(b)[0])
                         for job, w, b in zip(_mlp_phase1(tx, tg, tws, hs, activation, trailing), dws, dbs)]

    rng = np.random.default_rng(45)
    e, f = POST_EMBED, POST_FF
    w = lambda out, inp: (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(np.float32)
    v = lambda n, base=0.0: (base + 0.1 * rng.standard_normal(n)).astype(np.float32)
    w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down = w(e, e), v(e), v(e, 1.0), v(e), w(f, e), v(f), w(e, f), v(e)
    attn = rng.standard_normal((JAX_ROWS, e)).astype(np.float32)
    h = jnp.asarray(rng.standard_normal((JAX_ROWS, e)), jnp.bfloat16)
    g = jnp.asarray(0.1 * rng.standard_normal((JAX_ROWS, e)), jnp.bfloat16)
    jw = [jnp.asarray(a) for a in (w_o.T, w_up.T, w_down.T)]
    _, r1_pad, s_pad = jfb._post_run_fwd(jnp.asarray(attn), h, jw[0], jnp.asarray(b_o)[None], jnp.asarray(g2)[None],
                                         jnp.asarray(bb2)[None], jw[1], jnp.asarray(b_up)[None], jw[2],
                                         jnp.asarray(b_down)[None], "gelu", 64, True, True)
    want = jfb._post_run_bwd(jnp.asarray(attn), g, r1_pad, s_pad, *jw, jnp.asarray(g2)[None], jnp.asarray(bb2)[None],
                             "gelu", 64, True)
    as_torch = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    jobs = _post_phase1(torch.from_numpy(attn), as_torch(g).to(torch.bfloat16),
                        as_torch(r1_pad[:JAX_ROWS]).to(torch.bfloat16), as_torch(s_pad[:JAX_ROWS]).to(torch.bfloat16),
                        *(torch.from_numpy(a) for a in (w_o, w_up, w_down, g2, bb2)))
    # JAX's (dattn, dh, dw_o, db_o, dg2, dbb2, dw_up, db_up, dw_down, db_down).
    results[POST_CHAIN] = [(*job, np.asarray(want[i]).T, np.asarray(want[i + 1])[0])
                           for job, i in zip(jobs, (2, 6, 8))]
    return results


def _layer_input(h: torch.Tensor, kind: int) -> torch.Tensor:
    """H as phase 2's products read it, fp32 of bf16 values: an fp32 H
    rounded to bf16, a saved gelu pre-activation z as bf16(gelu(z)) of the
    tanh form (as the forward rounded it), a bf16 H as it is.  The kernel
    recomputes gelu in the sigmoid form z / (1 + e^(-2u)) of the same tanh
    form with fast intrinsics (``__expf``, ``__fdividef``): a few fp32 ulps
    from the forward's ``tanhf``, so where the fp32 value lies that close to
    a bf16 rounding edge its H is one bf16 ulp from this one, within the
    tolerance below."""
    if kind == SAVED:
        z = h.float()
        h = 0.5 * z * (1.0 + torch.tanh(0.7978845608028654 * (z + 0.044715 * z * z * z)))
    return h.to(torch.bfloat16).float()


@pytest.mark.parametrize("output", ["dW", "column sums"])
@pytest.mark.parametrize("chain, job", JAX_CASES, ids=[f"{c} job {j}" for c, j in JAX_CASES])
def test_plain_phase2_matches_jax_backward(jax_backwards, chain, job, output):
    """A plain phase 2 (dW = D^T H over bf16 values with fp32 sums, the bias
    from phase 1's per-row-tile column partials) of each job against JAX's
    backward, at the MLP's tolerances (tests/test_torch_fused_mlp.py)."""
    d_bf, h, kind, part, want_dw, want_db = jax_backwards[chain][job]
    if output == "dW":
        got, want = d_bf.float().T @ _layer_input(h, kind), want_dw
    else:
        got, want = part.sum(0), want_db
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-2)


@pytest.mark.parametrize("activation", ["elu", "gelu"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_wrappers_name_the_jobs_whose_h_the_blocks_convert(activation, x_dtype, monkeypatch):
    """The kinds of H the wrappers give the jobs (which the kernel takes as
    given and the plan's tile widths follow): layer 0's fp32 where x is
    fp32, the later layers' saved where they saved gelu pre-activations; the
    post block's W_o fp32 (the attention) and, under gelu, W_down saved."""
    seen = []
    make = dw.make_scratch
    monkeypatch.setattr(dw, "make_scratch", lambda *args: seen.append(args[4]) or make(*args))
    rng = np.random.default_rng(2)
    dims, rows = (48, 64, 32), 300
    xs, wss, hss = _mlp_inputs(rng, rows, dims, 1)
    gs = [torch.zeros(rows, dims[-1], dtype=torch.bfloat16)]
    fm._bwd_params([xs[0].to(x_dtype)], gs, wss, hss, activation, True, False, None, None)
    assert seen.pop() == [F32 if x_dtype == torch.float32 else B, SAVED if activation == "gelu" else B]
    monkeypatch.setattr(fb, "_launch", lambda *args, **kwargs: None)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bf = lambda *shape: t(*shape).to(torch.bfloat16)
    e, f = 32, 64
    fb._launch_post_bwd([t(rows, e)], [bf(rows, e)], [bf(rows, e)], [bf(rows, f)],
                        [(t(e, e), t(f, e), t(e, f), t(e), t(e))], activation, "K4post_b")
    assert seen.pop() == [F32, B, SAVED if activation == "gelu" else B]
