"""K6's and K3f's launch plans (``lane::launch_band`` in
``csrc/lane_attention.cu``), mirrored by ``lane_attention.next_plan`` and
``fwd_plan``, on the CPU: lanes per query, problems per block, threads and
shared memory (and K3f's score passes) at every head dim, dtype and query
count the kernels take, and the parameter blocks that read the main path's
views in place.  The card checks the kernels' own plans against them
(``test_next_token_plan_matches_the_python_mirror``,
``test_lane_fwd_plan_matches_the_python_mirror``)."""

import pytest
import torch

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
