"""The work a kernel call must do, frozen for the benchmark.

FLOP and bytes of one call, counted from its shapes: each input byte read
once, each output byte written once, whatever the kernel reads again.  These
are the formulas of ``chip_smoke.py`` (``_chain_work``, ``_block_work``,
``_lane_work``, ``_bound_ms``) with the module constants they read made
arguments, so that the benchmark keeps them whatever the program's scripts
become.  The attention's work depends on which (query, key) pairs are
valid; ``band_pairs`` counts them for a band whose keys are all valid.
"""

from __future__ import annotations

__all__ = ["PEAK_BF16_FLOPS", "PEAK_BYTES", "PEAK_FP32_FLOPS", "band_pairs", "block_work", "bound_s", "chain_work",
           "lane_work"]

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # CUDA cores: the attention kernels do no tensor-core work
PEAK_BYTES = 3.35e12


def chain_work(rows: int, chains: int, backward: bool, save_hiddens: bool, input_grad: bool, dims,
               x_bytes: int = 4) -> tuple[float, float]:
    """(FLOP, bytes) of one MLP chain call (K1f/K2f forward, K1b/K2b
    backward) over ``chains`` chains of widths ``dims``: x read at
    ``x_bytes`` an element, bf16 activations, fp32 weights and gradients."""
    pairs = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    macs = sum(a * b for a, b in pairs)
    params = macs + sum(b for _, b in pairs)
    hidden = sum(b for _, b in pairs[:-1])
    if not backward:
        flops = 2 * rows * macs
        nbytes = rows * dims[0] * x_bytes + params * 4 + rows * dims[-1] * 2 + (rows * hidden * 2 if save_hiddens else 0)
    else:
        dx_macs = sum(a * b for a, b in (pairs if input_grad else pairs[1:]))
        flops = 2 * rows * (macs + dx_macs)
        nbytes = (rows * dims[0] * x_bytes + rows * dims[-1] * 2 + rows * (hidden + dims[-1]) * 2  # x, g, saved h
                  + macs * 4 + params * 4 + (rows * dims[0] * 4 if input_grad else 0))  # W, dW + db, dx
    return chains * flops, chains * nbytes


def block_work(op: str, rows: int, chains: int, embed: int, ff: int, inp: int, save: bool = True) -> tuple[float, float]:
    """(FLOP, bytes) of one fused encoder-block op (``pre_f``, ``pre_b``,
    ``post_f``, ``post_b``; the pre backward with skip_input_grad): the
    pre op is the input projection and the qkv projection, the post op the
    output projection and the feed-forward; h travels as fp32, the other
    activations as bf16."""
    e, f, i = embed, ff, inp
    if op.startswith("pre"):
        params = i * e + 3 * e * e + 6 * e
        if op == "pre_f":
            flops = 2 * rows * (i * e + 3 * e * e)
            nbytes = rows * i * 4 + params * 4 + rows * e * 4 + rows * 3 * e * 2
        else:
            flops = 2 * rows * (6 * e * e + e * i)
            nbytes = (rows * (i * 4 + e * 4 + e * 4 + 3 * e * 2) + (i * e + 3 * e * e + 2 * e) * 4  # x, h, gh, gqkv, W
                      + params * 4)  # gradients
    else:
        params = e * e + 2 * e * f + 5 * e + f
        if op == "post_f":
            flops = 2 * rows * (e * e + 2 * e * f)
            nbytes = rows * e * 8 + params * 4 + rows * e * 2 + ((rows * e * 2 + rows * f * 2) if save else 0)
        else:
            flops = 2 * rows * (2 * e * e + 4 * e * f)
            nbytes = (rows * (e * 4 + e * 2 + e * 2 + f * 2) + (e * e + 2 * e * f + 2 * e) * 4  # attn, g, r1, s, W
                      + rows * e * 8 + params * 4)  # dattn, dh, gradients
    return chains * flops, chains * nbytes


def band_pairs(t_len: int, window: int, first: int = 0) -> int:
    """(query, key) pairs of one environment and head in a band of
    ``window + 1`` keys ending at each query (``first`` = 1 leaves out the
    query's own position: the next-token pass), every key valid."""
    return t_len * (window + 1 - first)


def lane_work(kind: str, n: int, heads: int, t_len: int, window: int, dim: int, pairs: int, save: bool = False,
              out_bytes: int = 4) -> tuple[float, float]:
    """(FLOP, bytes) of K3f / K3b / K6 over ``n`` environments: q is
    ``[n, heads, t_len, dim]``, k and v ``[n, heads, window + t_len, dim]``
    (the cache ahead of the sequence), bf16; ``pairs`` valid (query, key)
    pairs per head summed over the environments; the int32 masks; K3b's dq,
    dk and dv at ``out_bytes`` each."""
    q_numel = n * heads * t_len * dim
    k_numel = n * heads * (window + t_len) * dim
    mask_bytes = 4 * (n * t_len + 2 * n * (window + t_len))
    if kind == "K6":
        # The next-token pass: each position's next token against the keys
        # after the query (``pairs`` counted with first = 1) and itself;
        # q, k_self and v_self have q's shape.
        all_pairs = pairs * heads + n * t_len * heads
        nbytes = 2 * (3 * q_numel + 2 * k_numel) + mask_bytes + 4 * q_numel
        return 4 * dim * all_pairs, nbytes
    probs = n * heads * t_len * (window + 1)
    if kind == "K3f":
        nbytes = 2 * (q_numel + 2 * k_numel) + mask_bytes + 4 * q_numel + (4 * probs if save else 0)
        return 4 * dim * pairs * heads, nbytes
    nbytes = 2 * (q_numel + 2 * k_numel) + 4 * probs + 4 * q_numel + out_bytes * (q_numel + 2 * k_numel)
    return 8 * dim * pairs * heads, nbytes


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a call: the larger of its FLOP at the peak rate
    and its bytes at the peak bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
