"""The band attention kernels' launch plans, mirrored in Python, on the CPU:
K6's, K3f's and K3b's (``lane::launch`` in ``csrc/lane_attention.cu``;
``lane_attention.next_plan``, ``fwd_plan``, ``bwd_plan``) and K7f's
(``banded::launch`` in ``csrc/banded_attention.cu``;
``banded_attention.fwd_plan``): lanes per query, problems or queries per
block, threads and shared memory (and the passes over the band) at every
head dim, dtype and query count the kernels take, and the parameter blocks
that read the main path's views in place.  The card checks the kernels' own
plans against them (``test_next_token_plan_matches_the_python_mirror``,
``test_lane_fwd_plan_matches_the_python_mirror``,
``test_lane_bwd_plan_matches_the_python_mirror``,
``test_banded_plan_matches_the_python_mirror``)."""

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import banded_attention as ba
from cusrl_tpu_torch.nn.kernels import lane_attention as la


@pytest.mark.parametrize("window", [0, 4, 16, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [1, 5, 24, 64, 128])
def test_next_plan_fits_and_fills_the_block(t_len, dim, dtype, window):
    plan = la.next_plan(t_len, window, dim, dtype)
    size = 2 if dtype == torch.bfloat16 else 4
    units = dim * size // 16  # 16-byte units per row
    assert plan["lanes"] == min(units, 4) and units % plan["lanes"] == 0 and 32 % plan["lanes"] == 0
    assert plan["threads"] == plan["problems"] * t_len * plan["lanes"] <= 512
    assert plan["smem_bytes"] == plan["problems"] * (window + t_len) * (2 * dim * size + 8) <= 232448
    if plan["problems"] > 1:  # more problems only while the block stays within 64 KB and 512 threads
        assert plan["smem_bytes"] <= 64 * 1024
    bigger = plan["problems"] + 1
    assert (bigger * t_len * plan["lanes"] > 512 or bigger * (window + t_len) * (2 * dim * size + 8) > 64 * 1024
            or plan["threads"] >= 256)


def test_next_plan_at_the_zoo_shape():
    """Velocity-Flat transformer_ppo: T = 24, W = 16, D = 32, bf16: four lanes
    a query, three problems (288 threads) a block, 16,320 B staged."""
    assert la.next_plan(24, 16, 32, torch.bfloat16) == dict(lanes=4, problems=3, threads=288, smem_bytes=16320)


def test_next_params_read_views_in_place():
    """The main path's operands as K6 reads them: a transposed q_seg and a
    head-split view of v_self keep their strides (no copy), a row that would
    not be 16-byte aligned is copied, masks of another dtype are cast."""
    n, heads, t_len, window, dim = 3, 4, 24, 16, 32
    proj = torch.zeros(n, t_len, 3 * heads * dim, dtype=torch.bfloat16)
    v_self = proj[..., 2 * heads * dim:].reshape(n, t_len, heads, dim).transpose(1, 2)
    q = torch.zeros(n, heads, t_len, dim, dtype=torch.bfloat16)
    k = torch.zeros(n, heads, window + t_len, dim, dtype=torch.bfloat16)
    q_seg = torch.zeros(t_len, n, dtype=torch.int32).T
    k_seg = torch.zeros(n, window + t_len, dtype=torch.int32)
    k_valid = torch.ones(n, window + t_len, dtype=torch.int64)
    p, keep = la._next_params(q, q, v_self, k, k, q_seg, k_seg, k_valid, window, None)
    assert keep[2].data_ptr() == v_self.data_ptr() and list(p.svs) == [t_len * 3 * heads * dim, dim,
                                                                      3 * heads * dim]
    assert keep[5].data_ptr() == q_seg.data_ptr() and list(p.sqseg) == [1, n]
    assert keep[7].dtype == torch.int32 and list(p.skval) == [window + t_len, 1]
    odd = torch.zeros(n * heads * t_len * dim + 1, dtype=torch.bfloat16)[1:].view(n, heads, t_len, dim)
    p, keep = la._next_params(odd, q, q, k, k, q_seg, k_seg, k_valid, window, None)
    assert keep[0].data_ptr() % 16 == 0 and torch.equal(keep[0], odd)


@pytest.mark.parametrize("window", [0, 4, 16, 31, 32, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [1, 5, 24, 128])
def test_fwd_plan_is_k6s_staging_with_its_score_passes(t_len, dim, dtype, window):
    """K3f stages what K6 stages (the W+T K and V rows and a (segment,
    valid) pair per key), so its layout is K6's; its band of W+1 keys is
    scored in one pass of 32 kept in registers, or in two (computed again);
    blocks of up to 288 threads take the instance built for three to an SM,
    within the SM's 2,048 threads."""
    plan = la.fwd_plan(t_len, window, dim, dtype)
    assert {k: v for k, v in plan.items() if k not in ("passes", "blocks_per_sm")} == la.next_plan(
        t_len, window, dim, dtype)
    assert plan["passes"] == (1 if window + 1 <= 32 else 2)
    assert plan["blocks_per_sm"] == (3 if plan["threads"] <= 288 else 1)
    assert plan["blocks_per_sm"] * plan["threads"] <= 2048


def test_fwd_plan_at_the_zoo_shape():
    """Velocity-Flat transformer_ppo: T = 24, W = 16, D = 32, bf16: four lanes
    a query, three problems (288 threads) a block, three blocks to an SM,
    the 17 band keys in one pass."""
    assert la.fwd_plan(24, 16, 32, torch.bfloat16) == dict(lanes=4, problems=3, threads=288, smem_bytes=16320,
                                                            passes=1, blocks_per_sm=3)


def test_fwd_params_read_views_in_place():
    """The main path's operands as K3f reads them: a transposed q_seg and a
    head-split view of q keep their strides (no copy), int32 masks are read
    as they are, a row that would not be 16-byte aligned is copied, masks of
    another dtype are cast; the output and probabilities are the wrapper's
    own contiguous tensors."""
    n, heads, t_len, window, dim = 3, 4, 24, 16, 32
    proj = torch.zeros(n, t_len, 3 * heads * dim, dtype=torch.bfloat16)
    q = proj[..., :heads * dim].reshape(n, t_len, heads, dim).transpose(1, 2)
    k = torch.zeros(n, heads, window + t_len, dim, dtype=torch.bfloat16)
    q_seg = torch.zeros(t_len, n, dtype=torch.int32).T
    k_seg = torch.zeros(n, window + t_len, dtype=torch.int32)
    k_valid = torch.ones(n, window + t_len, dtype=torch.int64)
    p, keep = la._fwd_params(q, k, k, q_seg, k_seg, k_valid, window, None)
    assert keep[0].data_ptr() == q.data_ptr() and list(p.sq) == [t_len * 3 * heads * dim, dim, 3 * heads * dim]
    assert keep[1].data_ptr() == k.data_ptr() and list(p.sk) == list(k.stride()[:-1])
    assert keep[3].data_ptr() == q_seg.data_ptr() and list(p.sqseg) == [1, n]
    assert keep[4].data_ptr() == k_seg.data_ptr() and list(p.skseg) == [window + t_len, 1]
    assert keep[5].dtype == torch.int32 and list(p.skval) == [window + t_len, 1]
    assert (p.q, p.k, p.v, p.q_seg) == (q.data_ptr(), k.data_ptr(), k.data_ptr(), q_seg.data_ptr())
    odd = torch.zeros(n * heads * t_len * dim + 1, dtype=torch.bfloat16)[1:].view(n, heads, t_len, dim)
    p, keep = la._fwd_params(odd, k, k, q_seg, k_seg, k_valid, window, None)
    assert keep[0].data_ptr() % 16 == 0 and torch.equal(keep[0], odd) and p.q == keep[0].data_ptr()


def _sizes(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("window", [4, 16, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [5, 24, 64])
def test_bwd_plan_fits_and_fills_the_block(t_len, dim, dtype, window):
    """K3b stages the K and V rows, the q rows, the fp32 cotangent (rows
    padded by 16 bytes) and the probabilities and ds (rows of an odd count of
    floats) per problem; its blocks take K3f's lanes and problem rule, within
    the shared memory and the 512 threads a block may use, three to an SM
    for blocks of up to 288 threads."""
    plan = la.bwd_plan(t_len, window, dim, dtype)
    size = _sizes(dtype)
    stage = (2 * (window + t_len) + t_len) * dim * size + t_len * (dim + 4) * 4 + 2 * t_len * ((window + 1) | 1) * 4
    assert la.bwd_stage_bytes(t_len, window, dim, size) == stage
    assert plan["lanes"] == la.fwd_plan(t_len, window, dim, dtype)["lanes"]
    assert plan["threads"] == plan["problems"] * t_len * plan["lanes"] <= 512
    assert plan["smem_bytes"] == plan["problems"] * stage <= 232448
    if plan["problems"] > 1:
        assert plan["smem_bytes"] <= 64 * 1024
    bigger = plan["problems"] + 1
    assert bigger * t_len * plan["lanes"] > 512 or bigger * stage > 64 * 1024 or plan["threads"] >= 256
    assert plan["passes"] == (1 if window + 1 <= 32 else 2)
    assert plan["blocks_per_sm"] == (3 if plan["threads"] <= 288 else 1)
    assert plan["blocks_per_sm"] * plan["threads"] <= 2048


def test_bwd_plan_at_the_zoo_shape():
    """Velocity-Flat transformer_ppo: T = 24, W = 16, D = 32, bf16: four lanes
    a query, three problems (288 threads) a block, three blocks to an SM,
    13,376 B staged a problem (K, V 2,560 B each, q 1,536, g 3,456, w and ds
    1,632 each), the 17 band keys in one pass."""
    assert la.bwd_stage_bytes(24, 16, 32, 2) == 13376
    assert la.bwd_plan(24, 16, 32, torch.bfloat16) == dict(lanes=4, problems=3, threads=288, smem_bytes=40128,
                                                            passes=1, blocks_per_sm=3)


def _merged_cotangent(n, heads, t_len, dim, dtype=torch.float32):
    """The gradient that reaches the attention's output on the main path:
    the merged heads' ``[T*N, H*D]`` cotangent seen as ``[N, H, T, D]``."""
    flat = torch.zeros(t_len * n, heads * dim, dtype=dtype)
    return flat.view(t_len, n, heads, dim).permute(1, 2, 0, 3)


def test_bwd_params_read_views_in_place():
    """The operands as K3b reads them: a head-split view of q and the
    transposed cotangent keep their strides (no copy), the probabilities are
    K3f's contiguous output, no mask is read; a cotangent in another dtype
    is cast to fp32, a row that would not be 16-byte aligned is copied."""
    n, heads, t_len, window, dim = 3, 4, 24, 16, 32
    proj = torch.zeros(n, t_len, 3 * heads * dim, dtype=torch.bfloat16)
    q = proj[..., :heads * dim].reshape(n, t_len, heads, dim).transpose(1, 2)
    k = torch.zeros(n, heads, window + t_len, dim, dtype=torch.bfloat16)
    probs = torch.zeros(n, heads, t_len, window + 1)
    g = _merged_cotangent(n, heads, t_len, dim)
    q_seg = torch.zeros(t_len, n, dtype=torch.int32).T
    k_seg = torch.zeros(n, window + t_len, dtype=torch.int64)
    k_valid = torch.ones(n, window + t_len, dtype=torch.int64)
    p, keep = la._bwd_params(q, k, k, probs, g, q_seg, k_seg, k_valid, window)
    assert keep[0].data_ptr() == q.data_ptr() and list(p.sq) == [t_len * 3 * heads * dim, dim, 3 * heads * dim]
    assert keep[3].data_ptr() == g.data_ptr() and list(p.sg) == [heads * dim, dim, n * heads * dim]
    assert (p.q, p.k, p.v, p.g, p.probs) == (q.data_ptr(), k.data_ptr(), k.data_ptr(), g.data_ptr(),
                                             probs.data_ptr())
    assert not p.q_seg and not p.k_seg and not p.k_valid and len(keep) == 5
    assert p.out_bf16 == 0 and p.is_bf16 == 1 and p.window == window
    g16 = _merged_cotangent(n, heads, t_len, dim, torch.bfloat16)
    p, keep = la._bwd_params(q, k, k, probs, g16, q_seg, k_seg, k_valid, window)
    assert keep[3].dtype == torch.float32 and p.g == keep[3].data_ptr() and list(p.sg) == list(keep[3].stride()[:-1])
    odd = torch.zeros(n * heads * t_len * dim + 1, dtype=torch.bfloat16)[1:].view(n, heads, t_len, dim)
    p, keep = la._bwd_params(odd, k, k, probs, g, q_seg, k_seg, k_valid, window)
    assert keep[0].data_ptr() % 16 == 0 and torch.equal(keep[0], odd) and p.q == keep[0].data_ptr()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lane_cpu_backward_returns_the_inputs_dtype(dtype):
    """On the CPU the autograd wrapper's gradients come back in the inputs'
    dtype, as K3b writes them on the card: the plain version's fp32 sums
    rounded once."""
    gen = torch.Generator().manual_seed(4)
    n, heads, t_len, window, dim = 2, 2, 5, 3, 8
    q = torch.randn(n, heads, t_len, dim, generator=gen).to(dtype).requires_grad_()
    k, v = (torch.randn(n, heads, window + t_len, dim, generator=gen).to(dtype).requires_grad_() for _ in range(2))
    q_seg = torch.zeros(n, t_len, dtype=torch.int32)
    k_seg = torch.zeros(n, window + t_len, dtype=torch.int32)
    k_valid = torch.ones(n, window + t_len, dtype=torch.int32)
    g = torch.randn(n, heads, t_len, dim, generator=gen)
    la.lane_window_attention(q, k, v, q_seg, k_seg, k_valid, window=window).backward(g)
    _, probs = la.lane_fwd_plain(q, k, v, q_seg, k_seg, k_valid, window, None, True)
    want = la.lane_bwd_plain(q.detach(), k.detach(), v.detach(), probs.detach(), g, window)
    for leaf, ref in zip((q, k, v), want):
        assert leaf.grad.dtype == dtype
        assert torch.equal(leaf.grad, ref.to(dtype))


@pytest.mark.parametrize("window", [0, 16, 40, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim", [8, 16, 32, 64])
@pytest.mark.parametrize("t_len", [5, 24, 64, 200, 256])
def test_banded_plan_fits(t_len, dim, dtype, window):
    """K7f's block within the shared memory and the 256 threads a block may
    use.  bf16 with D >= 16 on tensor cores: a warp per 16 queries, up to 128
    a block (a multiple of 16 that covers a short sequence), staging the K
    and V rows its warps' chunks of 32 keys reach (rows past the band zero),
    its q rows, each padded by 16 bytes, and a (segment, valid) pair per key
    row.  Otherwise K3f's lanes: ``256 / lanes`` queries (a multiple of 8),
    the band's K and V rows and pairs, one pass where the band's keys fit
    32."""
    plan = ba.fwd_plan(t_len, window, dim, dtype)
    size = _sizes(dtype)
    bq = plan["block_q"]
    assert plan["threads"] == bq * plan["lanes"] <= 256 and plan["smem_bytes"] <= 232448
    if plan["tensor_cores"]:
        assert size == 2 and dim >= 16 and plan["lanes"] == 2
        assert bq % 16 == 0 and 16 <= bq <= 128 and bq < t_len + 16
        chunks = -(-(16 + window) // 32)
        rows = bq - 16 + 32 * chunks
        assert rows >= bq + window and plan["passes"] == chunks
        assert plan["smem_bytes"] == (2 * rows + bq) * (dim + 8) * 2 + rows * 8
        assert plan["blocks_per_sm"] == (3 if dim <= 32 else 2)
    else:
        assert (size == 4 or dim == 8) and plan["lanes"] == min(dim * size // 16, 4)
        assert bq % 8 == 0 and 8 <= bq <= 256 // plan["lanes"] and bq < t_len + 8
        assert plan["smem_bytes"] == (bq + window) * (2 * dim * size + 8)
        if bq < min(256 // plan["lanes"], -(-t_len // 8) * 8):  # halved only while the band did not fit
            assert (2 * bq + window) * (2 * dim * size + 8) > 232448
        assert plan["passes"] == (1 if window + 1 <= 32 else 2) and plan["blocks_per_sm"] == 3


def test_banded_plan_at_the_long_rollout_shape():
    """Path TL: T = 256, W = 16, D = 32, bf16, on tensor cores: 128 queries
    (eight warps, 256 threads) a block, so 256 queries fill two blocks; 144
    key rows and 128 q rows staged at 80 B a row, 34,432 B; the 32 keys a
    warp's queries see in one chunk.  A ragged T = 200 takes the same block
    (its second 72 queries full); W = 160 takes six chunks."""
    assert ba.fwd_plan(256, 16, 32, torch.bfloat16) == dict(lanes=2, block_q=128, threads=256, smem_bytes=34432,
                                                            passes=1, blocks_per_sm=3, tensor_cores=1)
    assert ba.fwd_plan(200, 16, 32, torch.bfloat16)["block_q"] == 128
    assert ba.fwd_plan(70, 160, 32, torch.bfloat16) == dict(lanes=2, block_q=80, threads=160, smem_bytes=49408,
                                                           passes=6, blocks_per_sm=3, tensor_cores=1)
    assert ba.fwd_plan(256, 16, 32, torch.float32) == dict(lanes=4, block_q=64, threads=256, smem_bytes=21120,
                                                           passes=1, blocks_per_sm=3, tensor_cores=0)


@pytest.mark.parametrize("dim", [16, 32, 64])
def test_banded_plan_takes_wide_bf16_windows_on_lanes(dim):
    """bf16 at D >= 16 stays on tensor cores while their staging fits at 16
    queries, and past that takes the lanes path, so every window the
    first-slice kernel took still has a plan.  That kernel staged, at its
    smallest block of 32 queries, ``D * 2 / 4 + 1`` words per K and V row
    and two ints per key row."""
    per_row = 2 * 4 * (dim * 2 // 4 + 1) + 8
    widest_before = 232448 // per_row - 32
    tc = [w for w in range(0, widest_before + 1) if ba.fwd_plan(64, w, dim, torch.bfloat16)["tensor_cores"]]
    assert tc == list(range(len(tc))) and 0 < len(tc) <= widest_before
    for window in (len(tc), widest_before):
        plan = ba.fwd_plan(64, window, dim, torch.bfloat16)
        assert plan["tensor_cores"] == 0 and plan["block_q"] >= 8
        assert plan == dict(plan, lanes=min(dim * 2 // 16, 4), passes=2, blocks_per_sm=3)
        assert plan["smem_bytes"] == (plan["block_q"] + window) * (2 * dim * 2 + 8) <= 232448
    assert ba.fwd_plan(256, 800, 64, torch.bfloat16) == dict(lanes=4, block_q=64, threads=256, smem_bytes=228096,
                                                             passes=2, blocks_per_sm=3, tensor_cores=0)


def test_banded_params_read_views_in_place():
    """The operands as K7f reads them: a head-split view of q and a
    transposed q_seg keep their strides (no copy), int32 masks are read as
    they are, masks of another dtype are cast, a row that would not be
    16-byte aligned is copied."""
    n, heads, t_len, window, dim = 3, 4, 72, 16, 32
    proj = torch.zeros(n, t_len, 3 * heads * dim, dtype=torch.bfloat16)
    q = proj[..., :heads * dim].reshape(n, t_len, heads, dim).transpose(1, 2)
    k = torch.zeros(n, heads, window + t_len, dim, dtype=torch.bfloat16)
    v = torch.zeros(n, heads, window + t_len, dim, dtype=torch.bfloat16)
    q_seg = torch.zeros(t_len, n, dtype=torch.int32).T
    k_seg = torch.zeros(n, window + t_len, dtype=torch.int32)
    k_valid = torch.ones(n, window + t_len, dtype=torch.int64)
    p, keep = ba._fwd_params(q, k, v, q_seg, k_seg, k_valid, window, (0.5, 0.25, 0.125, 0.0625))
    assert (p.q, p.k, p.v, p.q_seg, p.k_seg) == tuple(t.data_ptr() for t in (q, k, v, q_seg, k_seg))
    assert list(p.sq) == [t_len * 3 * heads * dim, dim, 3 * heads * dim] and list(p.sk) == list(k.stride()[:-1])
    assert list(p.sqseg) == [1, n] and list(p.skseg) == [window + t_len, 1]
    assert keep[5].dtype == torch.int32 and p.k_valid == keep[5].data_ptr() and list(p.skval) == [window + t_len, 1]
    assert p.use_alibi == 1 and list(p.slopes)[:4] == [0.5, 0.25, 0.125, 0.0625] and p.is_bf16 == 1
    odd = torch.zeros(n * heads * t_len * dim + 1, dtype=torch.bfloat16)[1:].view(n, heads, t_len, dim)
    p, keep = ba._fwd_params(odd, k, v, q_seg, k_seg, k_valid, window, None)
    assert keep[0].data_ptr() % 16 == 0 and torch.equal(keep[0], odd) and p.q == keep[0].data_ptr()
