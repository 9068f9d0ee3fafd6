"""The conditioning and the strength of ``chip_smoke.py``'s card-against-CPU
update check on path T (the transformer entry on its modular route), on the
CPU.  The check holds the card's metrics after one whole update to the
CPU's within 2e-3 + 2e-2 * |value|, and each leaf of the first minibatch's
gradient within 2e-2 of the leaf's largest element
(``chip_smoke.update_check_failures``).

* A change of every gradient at fp32 rounding size (a reordered sum on the
  card) must move no metric by more than a tenth of its limit.
  ``perturbed_update(1e-3, ...)`` shows why the check runs at lr 1e-4: at
  the zoo's 1e-3 the fresh policy moves to KL 0.19 and the
  importance-weighted advantage follows fp32 noise.
* A backward whose phase 2 leaves out a row split must fail the check.  The
  FFN's chain runs through ``fused_mlp`` here as on the card (its plain
  version on the CPU), and the planted fault drops the rows of the last or
  the first split of ``dw_row_splits`` from every dW and db of the chain.
"""

import contextlib
import importlib.util
from pathlib import Path

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import dw_phase2
from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
from cusrl_tpu_torch.nn.module.mlp import Mlp

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _perturbed_gradients(scale: float, seed: int):
    """Every agent built inside scales each parameter's gradient by
    ``1 + scale * noise`` (noise fixed per parameter, from ``seed``)."""
    from cusrl_tpu_torch.template.actor_critic import ActorCritic

    init = ActorCritic.__init__

    def patched(self, *args, **kwargs):
        init(self, *args, **kwargs)
        gen = torch.Generator().manual_seed(seed)
        for p in self.model.parameters():
            noise = torch.randn(p.shape, generator=gen)
            p.register_hook(lambda grad, n=noise: grad * (1 + scale * n))

    ActorCritic.__init__ = patched
    try:
        yield
    finally:
        ActorCritic.__init__ = init


def perturbed_update(lr: float, scale: float, seed: int = 123) -> tuple[dict, dict]:
    """Path T's ``check_update_against_cpu`` update on the CPU at ``lr``:
    ``(metrics, the first minibatch's gradient by parameter name)``."""
    from cusrl_tpu_torch.zoo.registry import get_experiment

    cs = _chip_smoke()
    steps, envs = 8, 256
    factory = get_experiment("Velocity-Flat", "transformer_ppo").make_agent_factory()
    factory.num_steps_per_update = steps
    factory.lr = lr
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    obs = torch.tanh(torch.randn(steps + 1, envs, cs.WIDTHS[0], generator=gen))
    terminated = torch.rand(steps, envs, 1, generator=gen) < 0.05
    truncated = torch.rand(steps, envs, 1, generator=gen) < 0.05
    perms = torch.stack([torch.randperm(envs, generator=torch.Generator().manual_seed(e)) for e in range(cs.EPOCHS)])
    with cs._fused_route(cs.PATH_ROUTES["T"]), _perturbed_gradients(scale, seed):
        metrics, grads, _ = cs._small_update(factory, "cpu", None, obs, terminated, truncated,
                                             terminated | truncated, perms)
    return metrics, grads


@pytest.fixture(scope="module")
def reference():
    """The check's CPU side: path T's update at lr 1e-4, unperturbed."""
    return perturbed_update(1e-4, 0.0)


def _fused_on_cpu(monkeypatch):
    """Routes every eligible MLP through ``fused_mlp`` on the CPU as well
    (``Mlp._can_fuse`` without its "tensor is on CUDA" term)."""
    can_fuse = Mlp._can_fuse
    monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: can_fuse(self, _CudaLike(x)))


class _CudaLike:
    """What ``Mlp._can_fuse`` reads of a tensor, with ``is_cuda`` true."""

    def __init__(self, x):
        self.shape, self.is_cuda = x.shape, True

    def dim(self):
        return len(self.shape)


def _dropping_split(which: str):
    """``mlp_chain_bwd_plain`` with the rows of the ``which`` ("last" or
    "first") split of phase 2 left out of every dW and db (dX whole)."""
    plain = fm.mlp_chain_bwd_plain
    seen = []

    def faulty(x, g, weights, hs, activation, trailing, skip_input_grad):
        dx, dws, dbs = plain(x, g, weights, hs, activation, trailing, skip_input_grad)
        shapes = [(w.shape[0], w.shape[1]) for w in weights]
        row_tiles = -(-x.shape[0] // dw_phase2.ROW_TILE)
        splits, _ = dw_phase2.dw_row_splits(row_tiles, dw_phase2.dw_tile_count(shapes), 1)
        seen.append(splits)
        keep = torch.ones(x.shape[0], 1, dtype=g.dtype)
        rows = dw_phase2.split_range(row_tiles, splits, splits - 1 if which == "last" else 0)
        keep[rows.start * dw_phase2.ROW_TILE:rows.stop * dw_phase2.ROW_TILE] = 0
        _, dws, dbs = plain(x, g * keep, weights, hs, activation, trailing, skip_input_grad)
        return dx, dws, dbs

    return faulty, seen


def test_path_t_update_check_is_well_conditioned_at_its_learning_rate(reference):
    (base, base_grads), (moved, moved_grads) = reference, perturbed_update(1e-4, 1e-7)
    assert set(base) == set(moved)
    for key, value in base.items():
        assert abs(moved[key] - value) <= 0.1 * (2e-3 + 2e-2 * abs(value)), (key, value, moved[key])
    assert _chip_smoke().update_check_failures(base, base_grads, moved, moved_grads) == []


def test_path_t_update_check_passes_the_fused_chain_on_the_cpu(reference, monkeypatch):
    """The control of the planted faults: the FFN through ``fused_mlp``'s
    plain version, without a fault, passes the check."""
    _fused_on_cpu(monkeypatch)
    calls = []
    chain_bwd = fm._chain_bwd
    monkeypatch.setattr(fm, "_chain_bwd", lambda *args: calls.append(1) or chain_bwd(*args))
    assert _chip_smoke().update_check_failures(*reference, *perturbed_update(1e-4, 0.0)) == []
    assert calls


@pytest.mark.parametrize("which", ["last", "first"])
def test_path_t_update_check_fails_a_backward_that_drops_a_phase2_split(reference, monkeypatch, which):
    _fused_on_cpu(monkeypatch)
    faulty, seen = _dropping_split(which)
    monkeypatch.setattr(fm, "mlp_chain_bwd_plain", faulty)
    failed = _chip_smoke().update_check_failures(*reference, *perturbed_update(1e-4, 0.0))
    assert seen and min(seen) > 1  # phase 2 splits these rows, so a split was dropped
    assert any(key.startswith("grad ") for key in failed), failed
