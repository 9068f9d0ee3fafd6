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
ignored.  A recurrent critic's ``ValueComputation.memory`` (a transformer's
ring, mask and cursor, a GRU's ``[N, layers, H]`` state, an LSTM's hidden and
cell states) is such hook state.  The recurrent cells' raw parameters
(``weights_ih.<layer>`` and the rest) load like any other parameter, under
``Sequential``'s member index.  ``actor_memory``, the JAX agent's
``state_dict()["actor_memory"]``, loads into the agent's carried actor
memory when given.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cusrl_tpu_torch.utils.nest import flatten_nested

__all__ = ["load_jax_state"]

_PARAMETER_PREFIXES = ("actor.", "critic.")


def _copy(path: str, target: torch.Tensor, value) -> None:
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":  # a bf16 ring; numpy's bfloat16 does not convert to torch
        value = value.astype(np.float32)
    value = torch.tensor(value, dtype=target.dtype)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch for '{path}': given {tuple(value.shape)}, port {tuple(target.shape)}")
    target.copy_(value.to(target.device))


def _load_tree(what: str, targets: dict, given: dict) -> None:
    missing = sorted(set(targets) - set(given))
    extra = sorted(set(given) - set(targets))
    if missing or extra:
        raise KeyError(f"{what} differs: missing {missing}, extra {extra}")
    for path, tensor in targets.items():
        _copy(path, tensor, given[path])


@torch.no_grad()
def load_jax_state(agent, agent_state: Mapping[str, np.ndarray], actor_memory=None) -> None:
    """Copies every actor and critic parameter and every stateful hook's
    state (and ``actor_memory`` when given); raises on a missing or extra
    path or a shape mismatch."""
    params = dict(agent.model.named_parameters())
    _load_tree("parameter paths", params,
               {path: value for path, value in agent_state.items() if path.startswith(_PARAMETER_PREFIXES)})
    if actor_memory is not None:
        if agent.actor_memory is None:
            raise ValueError("actor_memory given for an actor without memory")
        _load_tree("actor memory", flatten_nested(agent.actor_memory), flatten_nested(actor_memory))

    for index, hook in enumerate(agent.hooks):
        tensors = hook.state_tensors()
        if not tensors:
            continue
        prefix = f"hooks.{index}."
        given = {
            path[len(prefix):]: value for path, value in agent_state.items()
            if path.startswith(prefix) and path[len(prefix):] not in hook.jax_config_fields
        }
        _load_tree(f"state of hook {index} ('{hook.hook_name}')", tensors, given)
