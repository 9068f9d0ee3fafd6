"""Carries weights and hook state from the JAX package into the port.

``load_jax_state(agent, agent_state)`` takes the flat ``{dotted_path: array}``
dict that ``cusrl_tpu``'s ``ActorCritic.state_dict()["agent_state"]``
produces.  Its ``actor.*`` and ``critic.*`` entries are the parameters; both
packages store ``Linear.weight`` as ``[out, in]``, so weights copy without a
transpose.  Its ``hooks.<index>.*`` entries carry the state of the hooks at
that position.  A hook's trainable networks (``trainable_modules()``, AMP's
discriminator) are parameters too: JAX's ``hooks.<index>.<module>.*``
entries load into the port's ``hooks.<hook_name>.<module>.*``.  For every
port hook with ``state_tensors()`` (observation normalization's statistics
and accumulators, the learning-rate schedule's scale and error
accumulators, AMP's ``transition_rms`` and expert ``dataset``) each of those
tensors is loaded, and a missing or extra path raises, as for parameters
(fields the hook lists in ``jax_config_fields`` are configuration and
skipped; so is AMP's ``rng``, a JAX PRNG key, since the port's hook draws
from a ``torch.Generator`` of its own).  Other entries
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
    index_of = {hook.hook_name: index for index, hook in enumerate(agent.hooks)}
    params = {}
    for path, param in agent.model.named_parameters():
        if path.startswith("hooks."):  # hooks.<hook_name>.<module>... -> hooks.<index>.<module>...
            _, name, rest = path.split(".", 2)
            path = f"hooks.{index_of[name]}.{rest}"
        params[path] = param
    module_prefixes = tuple(f"hooks.{index}.{module}." for index, hook in enumerate(agent.hooks)
                            for module in hook.trainable_modules())
    _load_tree("parameter paths", params, {path: value for path, value in agent_state.items()
                                           if path.startswith(_PARAMETER_PREFIXES + module_prefixes)})
    if actor_memory is not None:
        if agent.actor_memory is None:
            raise ValueError("actor_memory given for an actor without memory")
        _load_tree("actor memory", flatten_nested(agent.actor_memory), flatten_nested(actor_memory))

    for index, hook in enumerate(agent.hooks):
        tensors = hook.state_tensors()
        if not tensors:
            continue
        prefix = f"hooks.{index}."
        modules = tuple(f"{module}." for module in hook.trainable_modules())
        given = {
            path[len(prefix):]: value for path, value in agent_state.items()
            if path.startswith(prefix) and path[len(prefix):] not in hook.jax_config_fields
            and not path[len(prefix):].startswith(modules)
        }
        _load_tree(f"state of hook {index} ('{hook.hook_name}')", tensors, given)
