"""The port's recurrent backbones (``cusrl_tpu_torch/nn/module/rnn.py``) and
episode-boundary helpers (``nn/utils/recurrent.py``) against the JAX package
on the CPU, at small sizes (hidden 16, one and two layers, T = 8, N = 16).

Inputs come from numpy with a seed; the JAX module's weights are copied into
the port's by their dotted paths, which both packages share.  Every case has
dones in mid-sequence.  Tolerances: fp32 to summation order (1e-5); with
``compute_dtype="bfloat16"`` both sides multiply the same bf16 operands
exactly and accumulate in fp32, but a state element one fp32 ulp apart can
round to a neighbouring bf16 value at the next step's cast, so 2e-4 on the
forward.  The backward rounds each cotangent to bf16 where the forward cast
(``x.astype(bf16)``'s VJP in JAX, ``.float()``'s in PyTorch): there one
flipped rounding is a whole bf16 ulp (2^-8 of the element), so the bf16
gradients are held within 8e-3 relative and 2e-3 of the leaf's largest
element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.nn.base import reset_memory as jax_reset_memory
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.module.rnn import RnnFactory as JaxRnnFactory
from cusrl_tpu.nn.utils import recurrent as jax_recurrent
from cusrl_tpu_torch.nn.base import reset_memory
from cusrl_tpu_torch.nn.module.rnn import Gru, Lstm, Rnn, RnnFactory, VanillaRnn, _reset_carry, stacked_sequence
from cusrl_tpu_torch.nn.utils import recurrent

T, N, C, H = 8, 16, 6, 16
TOL = {None: dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-4, atol=2e-4)}
GRAD_TOL = {None: dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=2e-3)}  # atol x max |leaf|
CASES = [(cell, layers, dtype) for cell in ("gru", "lstm", "rnn") for layers in (1, 2) for dtype in (None, "bfloat16")]


def _pair(cell, layers, compute_dtype, seed=0):
    """The JAX module and the port's with the same weights."""
    jax_module = JaxRnnFactory(cell=cell, hidden_size=H, num_layers=layers, compute_dtype=compute_dtype)(
        C, None, jax.random.key(seed))
    module = RnnFactory(cell=cell, hidden_size=H, num_layers=layers, compute_dtype=compute_dtype)(
        C, None, torch.Generator().manual_seed(seed))
    params = dict(module.named_parameters())
    jax_params = dict(tree_paths(jax_module))
    assert set(params) == set(jax_params)
    with torch.no_grad():
        for path, p in params.items():
            p.copy_(torch.from_numpy(np.array(jax_params[path])))
    return jax_module, module


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, C)).astype(np.float32)
    done = rng.random((T, N, 1)) < 0.2
    done[3, :4] = True  # resets in mid-sequence whatever the draw
    return x, done


def _leaves(memory):
    """A memory's leaves as numpy arrays, in the order of their paths."""
    if isinstance(memory, torch.Tensor):
        return [memory.detach().numpy()]
    if isinstance(memory, dict):
        return [leaf for key in sorted(memory) for leaf in _leaves(memory[key])]
    return [np.asarray(memory)]


@pytest.mark.parametrize("cell,layers,compute_dtype", CASES)
def test_sequence_mode_matches_jax(cell, layers, compute_dtype):
    """Outputs, final memory, and the gradients of a scalar loss with respect
    to the input and every weight."""
    jax_module, module = _pair(cell, layers, compute_dtype)
    x, done = _inputs()
    rng = np.random.default_rng(2)
    w_out = rng.standard_normal((T, N, H)).astype(np.float32)
    w_mem = rng.standard_normal((N, layers, H)).astype(np.float32)

    def jax_loss(mod, x_):
        out, mem, _ = mod(x_, mod.init_memory(N), sequential=True, done=jnp.asarray(done))
        return jnp.sum(out * w_out) + sum(jnp.sum(m * w_mem) for m in jax.tree.leaves(mem)), (out, mem)

    (_, (jax_out, jax_mem)), (jax_gmod, jax_gx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax_module, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    out, mem, _ = module(tx, None, sequential=True, done=torch.from_numpy(done))
    leaves = [mem] if isinstance(mem, torch.Tensor) else [mem["cell"], mem["hidden"]]
    loss = (out * torch.from_numpy(w_out)).sum() + sum((m * torch.from_numpy(w_mem)).sum() for m in leaves)
    loss.backward()

    tol = TOL[compute_dtype]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_out), **tol)
    for got, want in zip(_leaves(mem), _leaves(jax_mem)):
        np.testing.assert_allclose(got, want, **tol)
    grad_tol = GRAD_TOL[compute_dtype]
    jax_grads = {"x": np.asarray(jax_gx), **{path: np.asarray(g) for path, g in tree_paths(jax_gmod)}}
    for path, got in [("x", tx.grad), *((path, p.grad) for path, p in module.named_parameters())]:
        want = jax_grads[path]
        np.testing.assert_allclose(got.numpy(), want, err_msg=path, rtol=grad_tol["rtol"],
                                   atol=grad_tol["atol"] * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("cell,layers,compute_dtype", CASES)
def test_stepwise_rollout_matches_jax_and_sequence_mode(cell, layers, compute_dtype):
    """Step by step with ``reset_memory`` after each step, as a rollout runs:
    the port against JAX, and the port's sequence mode against its own
    stepwise loop (``tests/test_recurrent.py``'s invariant), bit for bit."""
    jax_module, module = _pair(cell, layers, compute_dtype)
    x, done = _inputs()
    jax_mem, mem = jax_module.init_memory(N), module.init_memory(N)
    outs = []
    with torch.no_grad():
        for t in range(T):
            jax_out, jax_mem, _ = jax_module(jnp.asarray(x[t]), jax_mem)
            out, mem, _ = module(torch.from_numpy(x[t]), mem)
            np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), err_msg=f"step {t}", **TOL[compute_dtype])
            jax_mem = jax_reset_memory(jax_mem, jnp.asarray(done[t]))
            mem = reset_memory(mem, torch.from_numpy(done[t]))
            outs.append(out)
        for got, want in zip(_leaves(mem), _leaves(jax_mem)):
            np.testing.assert_allclose(got, want, **TOL[compute_dtype])
        seq_out, seq_mem, _ = module(torch.from_numpy(x), module.init_memory(N), sequential=True,
                                     done=torch.from_numpy(done))
    torch.testing.assert_close(seq_out, torch.stack(outs), rtol=0, atol=0)
    for got, want in zip(_leaves(seq_mem), _leaves(mem)):
        np.testing.assert_array_equal(got, want)


def test_modules_keep_the_jax_layout():
    gru = RnnFactory(cell="gru", hidden_size=H, num_layers=2)(C, None, torch.Generator().manual_seed(0))
    assert isinstance(gru, Gru) and gru.output_dim == H and gru.is_recurrent
    assert [tuple(p.shape) for p in gru.parameters()] == [(3 * H, C), (3 * H, H), (3 * H, H), (3 * H, H),
                                                          (3 * H,), (3 * H,), (3 * H,), (3 * H,)]
    assert not gru.supports_next_token_eval  # the JAX contract: recurrent modules opt in
    bound = 1 / np.sqrt(H)
    assert all(float(p.detach().abs().max()) <= bound for p in gru.parameters())
    assert gru.init_memory(N).shape == (N, 2, H) and gru.init_memory(N).dtype == torch.float32
    lstm = RnnFactory(cell="LSTM", hidden_size=H)(C, None)
    assert isinstance(lstm, Lstm) and set(lstm.init_memory(N)) == {"cell", "hidden"}
    assert Rnn is VanillaRnn and isinstance(RnnFactory(cell="rnn")(C, None), VanillaRnn)
    with pytest.raises(ValueError, match="Unsupported RNN cell"):
        RnnFactory(cell="conv")(C, None)


def test_initialization_hook_leaves_the_cells_alone():
    """``ModuleInitialization`` re-initialises ``Linear`` layers only, as the
    JAX hook does: the GRU's raw weights keep their uniform draw."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.preset.ppo import RecurrentPpoAgentFactory

    env = VelocityLocomotionEnv(num_instances=4, observation_dim=C, action_dim=2, device="cpu")
    factory = RecurrentPpoAgentFactory(rnn_hidden_size=H, mlp_hidden_dims=(8,))
    agent = factory(env.spec, device="cpu", seed=5)
    fresh = factory._backbone_factory(()).factories[0](C, None, torch.Generator().manual_seed(5))
    gru = agent.actor.backbone.members[0]
    for (path, p), q in zip(gru.named_parameters(), fresh.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=path)
    mlp = agent.actor.backbone.members[1].layers[0]
    assert float(mlp.bias.abs().max()) == 0.0  # the Linear was re-initialised (zero bias)


def test_reset_carry_zeroes_exactly_the_done_rows():
    rng = np.random.default_rng(4)
    memory = {"hidden": torch.from_numpy(rng.standard_normal((5, 2, 3)).astype(np.float32)),
              "cell": torch.from_numpy(rng.standard_normal((5, 2, 3)).astype(np.float32))}
    done = torch.tensor([[True], [False], [True], [False], [False]])
    reset = _reset_carry(memory, done)
    for key in memory:
        assert not reset[key][done[:, 0]].any()
        torch.testing.assert_close(reset[key][~done[:, 0]], memory[key][~done[:, 0]], rtol=0, atol=0)
    pair = torch.stack([memory["hidden"], memory["cell"]])  # the joint evaluation's [2, N, ...] stack
    stacked = _reset_carry(pair, done, pair_axis=True)
    assert not stacked[:, done[:, 0]].any()
    torch.testing.assert_close(stacked[:, ~done[:, 0]], pair[:, ~done[:, 0]], rtol=0, atol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stacked_sequence_matches_two_separate_passes(cell):
    """The pair of modules as one batched product a step (the joint
    evaluation's stack) gives each module's own sequence pass, gradients
    included."""
    _, a = _pair(cell, 2, None, seed=0)
    _, c = _pair(cell, 2, None, seed=3)
    x, done = _inputs()
    xa, xc = torch.from_numpy(x), torch.from_numpy(x[::-1].copy())
    done_t = torch.from_numpy(done)
    mem_a, mem_c = a.init_memory(N), c.init_memory(N)
    oa, oc, fa, fc = stacked_sequence(a, c, xa, xc, mem_a, mem_c, done_t)
    (oa.square().sum() + oc.sum()).backward()
    stacked_grads = [p.grad.clone() for p in (*a.parameters(), *c.parameters())]
    for p in (*a.parameters(), *c.parameters()):
        p.grad = None
    ra, rfa, _ = a(xa, mem_a, sequential=True, done=done_t)
    rc, rfc, _ = c(xc, mem_c, sequential=True, done=done_t)
    (ra.square().sum() + rc.sum()).backward()
    torch.testing.assert_close(oa, ra, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(oc, rc, rtol=1e-6, atol=1e-6)
    for got, want in zip(_leaves(fa) + _leaves(fc), _leaves(rfa) + _leaves(rfc)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for got, p in zip(stacked_grads, (*a.parameters(), *c.parameters())):
        torch.testing.assert_close(got, p.grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="one structure"):
        stacked_sequence(a, _pair("rnn", 2, None)[1], xa, xc, mem_a, mem_c, done_t)


def test_recurrent_helpers_match_jax():
    """The seven helpers of ``nn/utils/recurrent.py`` on the same dones,
    data and memories."""
    x, done = _inputs(seed=9)
    jdone, tdone = jnp.asarray(done), torch.from_numpy(done)
    for name in ("compute_cumulative_timesteps", "compute_reverse_cumulative_timesteps", "compute_sequence_lengths"):
        got, want = getattr(recurrent, name)(tdone), getattr(jax_recurrent, name)(jdone)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    padded, mask = recurrent.split_and_pad_sequences(torch.from_numpy(x), tdone)
    jax_padded, jax_mask = jax_recurrent.split_and_pad_sequences(jnp.asarray(x), jdone)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jax_padded))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_mask))
    np.testing.assert_array_equal(recurrent.unpad_and_merge_sequences(padded, mask).numpy(),
                                  np.asarray(jax_recurrent.unpad_and_merge_sequences(jax_padded, jax_mask)))
    rng = np.random.default_rng(10)
    stack = {"hidden": rng.standard_normal((T, N, 2, H)).astype(np.float32),
             "cell": rng.standard_normal((T, N, 2, H)).astype(np.float32)}
    tstack = {k: torch.from_numpy(v) for k, v in stack.items()}
    jstack = {k: jnp.asarray(v) for k, v in stack.items()}
    for temporal in (True, False):
        got = recurrent.select_initial_memory(tstack, temporal)
        want = jax_recurrent.select_initial_memory(jstack, temporal)
        for key in stack:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert recurrent.select_initial_memory(None) is None
    got = recurrent.concat_memory(tstack, tstack)
    want = jax_recurrent.concat_memory(jstack, jstack)
    for key in stack:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert recurrent.concat_memory(None, tstack) is tstack and recurrent.concat_memory(tstack, None) is tstack
