"""The fused block forwards' Python-side layout on the CPU: the weight images
the pack kernel writes (``fwd_stages``, and the pack shared with the MLP chain
forward, ``weight_images.pack_plain``) and the persistent blocks' tile
schedule (``FWD_GRID``, ``fwd_grid``, ``tile_schedule``).  No
kernel runs here; the card checks the kernels against the same plan
(``test_block_forward_plan_matches_the_python_mirror``)."""

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import fused_block as fb
from cusrl_tpu_torch.nn.kernels import weight_images as wi

WIDTHS = [(48, 128, 512), (16, 16, 16), (512, 128, 48), (48, 80, 144)]  # (in, embed, ffn)


def _matrices(op, in_dim, embed, ff, seed):
    gen = torch.Generator().manual_seed(seed)
    shapes = [(embed, in_dim), (3 * embed, embed)] if op == "pre" else [(embed, embed), (ff, embed), (embed, ff)]
    return [torch.randn(shape, generator=gen) for shape in shapes]


@pytest.mark.parametrize("op", ["pre", "post"])
@pytest.mark.parametrize("in_dim,embed,ff", WIDTHS)
def test_packed_images_unpack_to_the_bf16_weights(op, in_dim, embed, ff):
    """Every weight element lands in exactly one image and comes back as
    ``w.to(bfloat16)``; everything past a matrix's edge is 0."""
    mats = _matrices(op, in_dim, embed, ff, seed=in_dim + embed + ff)
    stages = fb.fwd_stages(op, in_dim, embed, ff)
    images = wi.pack_plain(mats, stages)
    assert images.shape == (len(stages), fb.STAGE_ROWS, fb.STAGE_COLS) and images.dtype == torch.bfloat16
    back = wi.unpack_plain(images, stages, [m.shape for m in mats])
    for m, b in zip(mats, back):
        assert torch.equal(b, m.to(torch.bfloat16))
    covered = sum(min(fb.STAGE_ROWS, mats[m].shape[0] - n0) * min(fb.STAGE_COLS, mats[m].shape[1] - k0)
                  for m, n0, k0 in stages)
    assert covered == sum(m.numel() for m in mats)  # no element twice
    assert int((images != 0).sum()) == sum(int((m.to(torch.bfloat16) != 0).sum()) for m in mats)


def test_image_rows_are_swizzled_by_16_byte_chunk():
    """Row n of an image holds logical chunk c (columns 8c .. 8c + 7) at
    chunk c ^ (n % 8): what a 128-byte-swizzled wgmma operand reads."""
    ids = ((torch.arange(128)[:, None] % 8) * 8 + torch.arange(64)[None, :] // 8).float()  # exact in bf16
    img = wi.pack_plain([ids], [(0, 0, 0)])[0].float()
    for n in (0, 1, 7, 8, 100):
        for c in range(8):
            assert torch.all(img[n, 8 * (c ^ (n % 8)):8 * (c ^ (n % 8)) + 8] == (n % 8) * 8 + c)


@pytest.mark.parametrize("op,in_dim,embed,ff,count", [("pre", 48, 128, 512, 7), ("post", 48, 128, 512, 18),
                                                      ("pre", 512, 128, 16, 14), ("post", 16, 16, 16, 3),
                                                      ("post", 48, 128, 48, 5)])
def test_image_order_follows_the_kernels(op, in_dim, embed, ff, count):
    """The kernels take W_in then [W_q; W_k; W_v] by 128-row chunk (pre),
    and W_o then, per 128-column chunk of the hidden, W_up's rows and
    W_down's columns of that chunk (post)."""
    stages = fb.fwd_stages(op, in_dim, embed, ff)
    assert len(stages) == count
    if op == "post" and ff == 512:
        assert stages[:6] == [(0, 0, 0), (0, 0, 64), (1, 0, 0), (1, 0, 64), (2, 0, 0), (2, 0, 64)]
        assert stages[-2:] == [(2, 0, 384), (2, 0, 448)]
    if op == "pre" and in_dim == 48:
        assert stages == [(0, 0, 0), (1, 0, 0), (1, 0, 64), (1, 128, 0), (1, 128, 64), (1, 256, 0), (1, 256, 64)]


@pytest.mark.parametrize("op", ["pre", "post"])
@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 6144 + 17, 65536 + 37])
def test_tile_schedule_covers_every_tile_once(rows, chains, sms, op):
    tile_rows, per_sm = fb.FWD_GRID[op]
    blocks, tiles = fb.fwd_grid(op, rows, chains, sms)
    assert tiles == -(-rows // tile_rows) and 1 <= blocks <= max(1, per_sm * sms // chains) and blocks <= tiles
    schedule = fb.tile_schedule(op, rows, chains, sms)
    assert sorted((c, t) for c, _, t in schedule) == [(c, t) for c in range(chains) for t in range(tiles)]
    per_block = [sum(1 for c, b, _ in schedule if (c, b) == (0, k)) for k in range(blocks)]
    assert max(per_block) - min(per_block) <= 1 and min(per_block) >= 1
