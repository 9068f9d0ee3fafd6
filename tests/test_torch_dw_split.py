"""Phase 2 of the backward kernels on the CPU: the split of the rows over
blocks (``nn/kernels/dw_phase2.py``) and the scratch the wrappers allocate
for it.  No kernel is built here; the kernels themselves are checked on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""

import ctypes

import numpy as np
import pytest
import torch

from cusrl_tpu_torch.nn.kernels import dw_phase2 as dw
from cusrl_tpu_torch.nn.kernels import fused_block as fb
from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

ROWS = (1, 63, 64, 65, 6_144, 24_576, 65_536, 65_537)
# (dW tiles per chain, chains) of the port's backwards: K4 pre (48 -> 128,
# 3 x 128), K4 post (FFN 512), the ELU head 128 -> 128, the MLP pair
# 48-512-256-128 (K2b, K8b, K9s, K9m), K5 post, the gelu FFN 128-512-128.
JOBS = {"K4pre": (14, 1), "K4post": (36, 1), "head": (4, 1), "mlp_pair": (48, 2), "K5post": (36, 2), "gelu": (16, 1)}


def _row_tiles(rows):
    return -(-rows // dw.ROW_TILE)


def split_ranges(row_tiles, splits, per):
    """The row tiles of each split as ``dw::split_kernel`` reads them: split
    ``s`` from ``s * per`` to ``min((s + 1) * per, row_tiles)``."""
    return [range(s * per, min((s + 1) * per, row_tiles)) for s in range(splits)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("job", sorted(JOBS))
def test_splits_cover_every_row_tile_once_in_order(rows, job):
    row_tiles = _row_tiles(rows)
    splits, per = dw.dw_row_splits(row_tiles, *JOBS[job])
    ranges = split_ranges(row_tiles, splits, per)
    assert len(ranges) == splits >= 1
    covered = [t for r in ranges for t in r]
    assert covered == list(range(row_tiles))  # each tile once, contiguous, in order
    assert all(len(r) == per for r in ranges[:-1]) and 1 <= len(ranges[-1]) <= per
    if row_tiles >= dw.MIN_TILES_PER_SPLIT:
        assert per >= dw.MIN_TILES_PER_SPLIT
    dw_tiles, chains = JOBS[job]
    wanted = dw.BLOCKS_PER_SM * dw.SMS
    # Enough blocks to fill the card (or every split holds its minimum).
    assert splits * dw_tiles * chains >= min(wanted, (row_tiles // dw.MIN_TILES_PER_SPLIT) * dw_tiles * chains) // 2


def test_same_shape_gives_the_same_splits():
    first = {(r, j): dw.dw_row_splits(_row_tiles(r), *JOBS[j]) for r in ROWS for j in JOBS}
    for (r, j), value in reversed(list(first.items())):
        assert dw.dw_row_splits(_row_tiles(r), *JOBS[j]) == value


@pytest.mark.parametrize("job", sorted(JOBS))
def test_one_split_for_a_single_row_tile(job):
    assert dw.dw_row_splits(1, *JOBS[job]) == (1, 1)
    assert split_ranges(1, 1, 1) == [range(0, 1)]


def test_main_path_splits():
    """The splits at the paths' shapes: TL's head (4 tiles) takes the most."""
    assert dw.dw_row_splits(_row_tiles(65_536), 4, 1) == (128, 8)
    assert dw.dw_row_splits(_row_tiles(65_536), 36, 1) == (15, 69)
    assert dw.dw_row_splits(_row_tiles(24_576), 48, 2) == (6, 64)
    assert dw.dw_row_splits(_row_tiles(65_537), 36, 1) == (15, 69)
    assert split_ranges(_row_tiles(65_537), 15, 69)[-1] == range(966, 1025)  # a short last split


def test_split_policy_refuses_empty_work():
    for args in ((0, 4, 1), (4, 0, 1), (4, 4, 0)):
        with pytest.raises(ValueError):
            dw.dw_row_splits(*args)


def test_scratch_shapes_and_struct():
    shapes = [(128, 48), (128, 128), (128, 128), (128, 128)]
    assert dw.dw_tile_count(shapes) == 14
    tiles, cols = dw.scratch_shapes(shapes, [768, 768], 15)
    assert tiles == (15, 128 * 48 + 3 * 128 * 128) and cols == [(15, 768), (15, 768)]
    s, tensors = dw.make_scratch(shapes, [768, 700], 65_537, "cpu")
    splits, per = dw.dw_row_splits(_row_tiles(65_537), 14, 2)
    assert (s.splits, s.per_split, s.dw_floats, list(s.col_floats)) == (splits, per, tiles[1], [768, 700])
    assert [tuple(t.shape) for t in tensors] == [(splits, tiles[1])] * 2 + [(splits, 768), (splits, 700)]
    assert [s.tiles[0], s.tiles[1], s.cols[0], s.cols[1]] == [t.data_ptr() for t in tensors]
    assert all(t.dtype == torch.float32 for t in tensors)
    # The ctypes mirror of DwScratch: four pointers, then five ints.
    assert ctypes.sizeof(dw.DwScratch) == 4 * ctypes.sizeof(ctypes.c_void_p) + 5 * 4 + 4


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
    splits, per = dw.dw_row_splits(_row_tiles(rows), dw.dw_tile_count([(64, 48), (32, 64)]), 2)
    assert (phase2.splits, phase2.per_split, phase2.dw_floats) == (splits, per, 64 * 48 + 32 * 64)
    strides = [0, 0]
    if heads is not None:
        strides = [a_dim * 32 + a_dim, v_dim * 32 + v_dim]
        if heads == "loss":
            strides = [strides[0] + 2 + a_dim, strides[1] + 2]
    assert list(phase2.col_floats) == [64 + 32 + strides[0], 64 + 32 + strides[1]]


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
        dw_floats, cols, tiles = e * i + 3 * e * e, 6 * e, dw.dw_tile_count([(e, i)] + [(e, e)] * 3)
    else:
        ws = (t(e, e), t(f, e), t(e, f), t(e), t(e))
        bf = lambda *shape: t(*shape).to(torch.bfloat16)
        fb._launch_post_bwd([t(rows, e)] * 2, [bf(rows, e)] * 2, [bf(rows, e)] * 2, [bf(rows, f)] * 2, [ws] * 2,
                            "gelu", "K5post_b")
        dw_floats, cols, tiles = e * e + 2 * e * f, 4 * e + f, dw.dw_tile_count([(e, e), (f, e), (e, f)])
    s = seen["phase2"]
    assert seen["entry"] == f"fused_block_{op}_bwd" and seen["chains"] == 2
    assert (s.splits, s.per_split) == dw.dw_row_splits(_row_tiles(rows), tiles, 2)
    assert (s.dw_floats, list(s.col_floats)) == (dw_floats, [cols, cols])
