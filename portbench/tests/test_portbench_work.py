"""The frozen work arithmetic (``work.arithmetic``) and the iteration's
schedule and model FLOP (``work.schedule``) against shapes counted by hand,
for both configurations."""

from __future__ import annotations

import collections

import pytest

from portbench.harness import spec
from portbench.work.arithmetic import PEAK_BF16_FLOPS, PEAK_BYTES, band_pairs, block_work, bound_s, chain_work, lane_work
from portbench.work.schedule import kernel_calls, model_flops, sizes_of


def test_chain_forward_by_hand():
    # dims 3 -> 4 -> 5 over 2 rows: 12 + 20 MACs a row; 41 parameters.
    assert chain_work(2, 1, False, False, False, (3, 4, 5)) == (2 * 2 * 32, 2 * 3 * 4 + 41 * 4 + 2 * 5 * 2)
    # Saving the hidden layer (4 wide, bf16) adds its bytes; two chains double everything.
    assert chain_work(2, 1, False, True, False, (3, 4, 5))[1] == 208 + 2 * 4 * 2
    assert chain_work(2, 2, False, False, False, (3, 4, 5)) == (256, 416)


def test_chain_backward_by_hand():
    # dW of both layers (32 MACs) and dX of the second only (20): x, g, the
    # saved h (4 + 5 wide, bf16), W in fp32, dW and db out in fp32.
    flops, nbytes = chain_work(2, 1, True, False, False, (3, 4, 5))
    assert flops == 2 * 2 * (32 + 20)
    assert nbytes == 2 * 3 * 4 + 2 * 5 * 2 + 2 * 9 * 2 + 32 * 4 + 41 * 4
    # With the input gradient: dX of the first layer too, and dx written in fp32.
    flops, nbytes_dx = chain_work(2, 1, True, False, True, (3, 4, 5))
    assert flops == 2 * 2 * (32 + 32) and nbytes_dx == nbytes + 2 * 3 * 4


def test_block_by_hand():
    # embed 4, ff 8, input 3, 2 rows: the pre op is 3x4 + 3 x 4x4 MACs a row.
    flops, nbytes = block_work("pre_f", 2, 1, 4, 8, 3)
    assert flops == 2 * 2 * (12 + 48)
    assert nbytes == 2 * 3 * 4 + (12 + 48 + 24) * 4 + 2 * 4 * 4 + 2 * 12 * 2
    # The post op: 4x4 + 2 x 4x8 MACs a row.
    assert block_work("post_f", 2, 1, 4, 8, 3, save=False)[0] == 2 * 2 * (16 + 64)
    assert block_work("post_b", 2, 1, 4, 8, 3)[0] == 2 * 2 * (32 + 128)


def test_lane_attention_by_hand():
    # 3 steps, window 1: 1 + 2 + 2 (query, key) pairs a head; 2 with the
    # query's own position left out.
    assert band_pairs(3, 1) == 3 * 2 and band_pairs(3, 1, first=1) == 3
    # One environment and head, 2 steps, window 1, dim 2: 4 pairs, QK and PV 2 x 2 FLOP each.
    flops, nbytes = lane_work("K3f", 1, 1, 2, 1, 2, band_pairs(2, 1))
    q, k, masks = 1 * 1 * 2 * 2, 1 * 1 * 3 * 2, 4 * (2 + 2 * 3)
    assert flops == 4 * 2 * 4
    assert nbytes == 2 * (q + 2 * k) + masks + 4 * q
    assert lane_work("K3b", 1, 1, 2, 1, 2, 4)[0] == 8 * 2 * 4


def test_bound_is_the_slower_of_compute_and_memory():
    assert bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert bound_s(1.0, PEAK_BYTES) == pytest.approx(1.0)
    assert PEAK_BF16_FLOPS == 989e12


def _sizes(config_name: str, envs: int = 16384):
    config = spec._read_json(spec.ROOT / f"portbench/configs/{config_name}.json")
    return sizes_of(config, {"environments_per_chip": envs})


def test_mlp_model_flops_by_hand():
    actor = 48 * 512 + 512 * 256 + 256 * 128 + 128 * 12  # 189,952 MACs a row
    critic = 48 * 512 + 512 * 256 + 256 * 128 + 128 * 1  # 188,544
    rows = 16384 * 24
    # Rollout actor, value and next-value critic passes, KL actor pass; then
    # 5 x 4 minibatches of a quarter of the rows: forward, dW everywhere, dX
    # but the first layer's.
    expected = 2 * (rows * (2 * actor + 2 * critic) + 20 * (rows // 4) * (3 * (actor + critic) - 2 * 48 * 512))
    assert model_flops(_sizes("velocity_rough_mlp")) == expected
    assert expected == pytest.approx(4.867e12, rel=1e-3)


def test_transformer_model_flops_by_hand():
    e, f, window = 128, 512, 16
    layer = 48 * e + 3 * e * e + 2 * (window + 1) * e + e * e + 2 * e * f  # projections, attention, FFN
    actor = layer + 128 * 128 + 128 * 12
    critic = layer + 128 * 128 + 128 * 1
    rows = 16384 * 24
    expected = 2 * (rows * (2 * actor + 2 * critic) + 20 * (rows // 4) * (3 * (actor + critic) - 2 * 48 * e))
    assert model_flops(_sizes("velocity_flat_transformer")) == expected


# Launches an iteration as the port's counters read them on the card
# (NVIDIA H100, 16,384 environments, ten iterations traced).
MEASURED = {
    "velocity_rough_mlp": {"K1f": 27, "K2f": 20, "K2b": 20},
    "velocity_flat_transformer": {"K1f": 91, "K1b": 40, "K4pre_f": 43, "K4post_f": 43, "K4pre_b": 40,
                                  "K4post_b": 40, "K3f": 42, "K3b": 40, "K6": 1},
}


@pytest.mark.parametrize("config_name", sorted(MEASURED))
def test_schedule_counts_the_calls_the_card_made(config_name):
    counts = collections.Counter()
    for call in kernel_calls(_sizes(config_name)):
        counts[call.key] += call.count
    assert dict(counts) == MEASURED[config_name]


def test_schedule_rows_follow_the_traffic():
    sizes = _sizes("velocity_rough_mlp", 262144)
    assert sizes.rows == 6_291_456 and sizes.mb_rows == 1_572_864
    chain = {c.key: c for c in kernel_calls(sizes) if c.key == "K2b"}["K2b"]
    assert chain.flops == chain_work(1_572_864, 2, True, False, False, (48, 512, 256, 128))[0]
