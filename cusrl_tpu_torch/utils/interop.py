"""Carries weights and hook state from the JAX package into the port.

``load_jax_state(agent, agent_state)`` takes the flat ``{dotted_path: array}``
dict that ``cusrl_tpu``'s ``ActorCritic.state_dict()["agent_state"]``
produces.  Its ``actor.*`` and ``critic.*`` entries are the parameters; both
packages store ``Linear.weight`` as ``[out, in]``, so weights copy without a
transpose.  Its ``hooks.<index>.*`` entries carry the state of the hooks at
that position: for every port hook with ``state_tensors()`` (observation
normalization's statistics and accumulators, the learning-rate schedule's
scale and error accumulators) each of those tensors is loaded, and a missing
or extra path raises, as for parameters (fields the hook lists in
``jax_config_fields`` are configuration and skipped).  Other entries
(configuration of the other hooks, optimizer state, the iteration) are
ignored.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_state"]

_PARAMETER_PREFIXES = ("actor.", "critic.")


def _copy(path: str, target: torch.Tensor, value) -> None:
    value = torch.tensor(np.asarray(value), dtype=target.dtype)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch for '{path}': given {tuple(value.shape)}, port {tuple(target.shape)}")
    target.copy_(value.to(target.device))


@torch.no_grad()
def load_jax_state(agent, agent_state: Mapping[str, np.ndarray]) -> None:
    """Copies every actor and critic parameter and every stateful hook's
    state; raises on a missing or extra path or a shape mismatch."""
    params = dict(agent.model.named_parameters())
    given = {path: value for path, value in agent_state.items() if path.startswith(_PARAMETER_PREFIXES)}
    missing = sorted(set(params) - set(given))
    extra = sorted(set(given) - set(params))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing}, extra {extra}")
    for path, param in params.items():
        _copy(path, param, given[path])

    for index, hook in enumerate(agent.hooks):
        tensors = hook.state_tensors()
        if not tensors:
            continue
        prefix = f"hooks.{index}."
        given = {
            path[len(prefix):]: value for path, value in agent_state.items()
            if path.startswith(prefix) and path[len(prefix):] not in hook.jax_config_fields
        }
        missing = sorted(set(tensors) - set(given))
        extra = sorted(set(given) - set(tensors))
        if missing or extra:
            raise KeyError(f"state of hook {index} ('{hook.hook_name}') differs: missing {missing}, extra {extra}")
        for name, tensor in tensors.items():
            _copy(prefix + name, tensor, given[name])
