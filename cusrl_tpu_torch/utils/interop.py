"""Carries weights from the JAX package into the port.

``load_jax_state(agent, agent_state)`` takes the flat ``{dotted_path: array}``
dict that ``cusrl_tpu``'s ``ActorCritic.state_dict()["agent_state"]``
produces.  Its ``actor.*`` and ``critic.*`` entries are the parameters; both
packages store ``Linear.weight`` as ``[out, in]``, so weights copy without a
transpose.  Other entries (hook settings, optimizer state, the iteration) are
not parameters of the port's modules and are ignored.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_state"]

_PARAMETER_PREFIXES = ("actor.", "critic.")


@torch.no_grad()
def load_jax_state(agent, agent_state: Mapping[str, np.ndarray]) -> None:
    """Copies every actor and critic parameter; raises on a missing or extra
    parameter path or a shape mismatch."""
    params = dict(agent.model.named_parameters())
    given = {path: value for path, value in agent_state.items() if path.startswith(_PARAMETER_PREFIXES)}
    missing = sorted(set(params) - set(given))
    extra = sorted(set(given) - set(params))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing}, extra {extra}")
    for path, param in params.items():
        value = torch.tensor(np.asarray(given[path]), dtype=param.dtype)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape mismatch for '{path}': given {tuple(value.shape)}, port {tuple(param.shape)}")
        param.copy_(value.to(param.device))
