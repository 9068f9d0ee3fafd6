"""The agent's state by the JAX package's paths: one path map for the
checkpoint writer, the checkpoint loader and ``load_jax_state``.

``state_entries(agent)`` lists every leaf of the JAX package's
``ActorCritic.state_dict()["agent_state"]`` that the port holds, under the
JAX path, each with a reader (to numpy) and a writer:

* ``actor.*`` and ``critic.*``: the parameters (both packages store
  ``Linear.weight`` as ``[out, in]``, so weights copy without a transpose; a
  module whose layout differs names the permutation that gives the JAX
  array in ``jax_layouts``, as the convolutions do: PyTorch's
  ``[out, in, kh, kw]`` against JAX's HWIO ``[kh, kw, in, out]``, the
  depthwise ``[C * m, 1, kh, kw]`` against ``[kh, kw, 1, C * m]``);
  a hook's networks (``owned_modules()``: trained ones such as AMP's
  discriminator and RND's predictor, frozen ones such as RND's target and
  the distillation expert), the port's ``hooks.<hook_name>.<module>.*``, go
  by JAX's ``hooks.<index>.<module>.*``;
* ``hooks.<index>.<field>``: every tensor of a hook's ``state_tensors()``
  (observation normalization's statistics and accumulators, the
  learning-rate schedule's scale and error accumulators, a recurrent critic's
  ``ValueComputation.memory``, AMP's ``transition_rms`` and expert
  ``dataset``), and the configuration the JAX hook keeps as leaves, the
  fields it lists in ``jax_config_fields`` (``gamma``, ``clip_ratio``, ...),
  read from and written to the hook's attributes (a tuple one element a
  leaf, ``<field>.<i>``, as JAX flattens it);
* ``opt_state.<group index>.inner_state.*``: the optax state of each
  parameter group (groups in sorted order, as both packages build them):
  Adam's ``count``, ``mu.<param path>`` and ``nu.<param path>`` are
  ``torch.optim.Adam``'s ``step``, ``exp_avg`` and ``exp_avg_sq`` (under
  ``inner_state.0`` for AdamW, whose chain adds a stateless decay); SGD's
  ``trace.<param path>`` is ``momentum_buffer`` (no state without momentum);
  RMSprop's ``nu.<param path>`` is ``square_avg``.  ``PackedAdam`` is
  ``opt_state.{count, mu.<path>, nu.<path>}``.  A parameter that has not
  stepped yet reads as zeros, as optax's initial state does;
* ``learning_rates.<group>`` and ``iteration``;
* an ``OptimizationStage``'s: its stage hooks' state and configuration under
  ``hooks.<index>.stage_hooks.<i>.``, its optimizer's state under
  ``hooks.<index>.opt_state.*`` (the same layout, over every trainable
  parameter of the agent, as JAX's stage optimizer holds) and
  ``hooks.<index>.stage_learning_rates.<group>``.  An optax group's ``count``
  is the step of the group's parameters that stepped most (a stage's
  optimizer never steps the actor's).

``JAX_ONLY_FIELDS`` names the JAX leaves with no port counterpart (AMP's PRNG
``rng``: the port's hook draws from a ``torch.Generator`` of its own); they
are neither written nor read.  The writer gives numpy arrays: int64 leaves go
out as int32 and bf16 ones (a transformer's ring) as fp32, since JAX keeps
32-bit integers and numpy has no bf16; both load back into either package.

``parameter_entries(module)`` gives those entries for any module, by its
own paths; ``load_jax_params(module, leaves)`` is their strict loader (the
JAX module's ``tree_paths`` as numpy, for a module outside an agent).
``load_jax_state(agent, agent_state)`` is the strict loader of parameters and
hook state (a missing or extra path or a shape mismatch raises; the
configuration, the optimizer state and the iteration are ignored);
``load_agent_state`` is the checkpoint's tolerant one (``load_state_dict``):
a missing path warns and keeps the initial value, a shape mismatch warns and
skips, unknown paths warn, as the JAX package's ``load_state_dict`` does.
``actor_memory`` is the agent's carried actor memory, by the JAX memory's
paths.

On a tensor-parallel agent a sharded parameter (its ``tp_shard``,
``parallel/tensor.py``) and its optimizer moments are entries of the full
shape: reading gathers the parts over the model group (a collective: every
model peer reads, in the same order), writing takes this rank's part of the
full array.  A rank-0 checkpoint of a tensor-parallel run therefore has the
one-process shapes, and loads into a one-process agent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from cusrl_tpu_torch.utils.nest import flatten_nested, map_nested

__all__ = [
    "JAX_ONLY_FIELDS",
    "load_agent_state",
    "load_jax_params",
    "load_jax_state",
    "parameter_entries",
    "state_entries",
    "to_numpy",
]

# Hook class name -> fields of the JAX hook's state that the port does not keep.
JAX_ONLY_FIELDS: dict[str, tuple[str, ...]] = {"AdversarialMotionPrior": ("rng",)}

_PARAMETER_PREFIXES = ("actor.", "critic.")


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A tensor as the checkpoint stores it: bf16 as fp32, int64 as int32."""
    tensor = tensor.detach()
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    elif tensor.dtype == torch.int64:
        tensor = tensor.to(torch.int32)
    return tensor.cpu().numpy()


def _copy(path: str, target: torch.Tensor, value) -> None:
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":  # a JAX bf16 ring; numpy's bfloat16 does not convert to torch
        value = value.astype(np.float32)
    value = torch.tensor(value, dtype=target.dtype)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch for '{path}': given {tuple(value.shape)}, port {tuple(target.shape)}")
    target.copy_(value.to(target.device))


@dataclasses.dataclass
class Entry:
    """One leaf: ``kind`` is parameter, state, config, optimizer,
    learning_rate or iteration."""

    kind: str
    shape: tuple[int, ...]
    read: Callable[[], np.ndarray]
    write: Callable[[str, np.ndarray], None]


def _tensor_entry(kind: str, tensor: torch.Tensor, shard=None) -> Entry:
    """A tensor's entry; with ``shard`` (a ``TensorShard``) the tensor is
    this rank's part, and the entry the full array."""
    if shard is None:
        return Entry(kind, tuple(tensor.shape), lambda: to_numpy(tensor), lambda path, v: _copy(path, tensor, v))
    return Entry(kind, shard.full_shape, lambda: to_numpy(shard.gather(tensor)),
                 lambda path, v: _copy(path, tensor, shard.take(np.asarray(v))))


def _permuted_entry(tensor: torch.Tensor, perm: tuple[int, ...]) -> Entry:
    """A parameter stored in another layout than JAX's: the JAX array is
    ``tensor.permute(perm)``."""
    inverse = tuple(perm.index(axis) for axis in range(len(perm)))
    return Entry("parameter", tuple(tensor.shape[axis] for axis in perm),
                 lambda: to_numpy(tensor.permute(perm)),
                 lambda path, v: _copy(path, tensor, np.transpose(np.asarray(v), inverse)))


def parameter_entries(module: torch.nn.Module) -> dict[str, Entry]:
    """Every parameter of ``module`` by its path, read and written in JAX's layout."""
    entries, owners = {}, dict(module.named_modules())
    for path, p in module.named_parameters():
        owner, _, name = path.rpartition(".")
        layouts = getattr(owners[owner], "jax_layouts", {})
        entries[path] = (_permuted_entry(p, layouts[name]) if name in layouts
                         else _tensor_entry("parameter", p, getattr(p, "tp_shard", None)))
    return entries


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, leaves: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copies a JAX module's leaves (``tree_paths``) into ``module``; raises
    on a missing or extra path or a shape mismatch."""
    _load_tree("parameter paths", parameter_entries(module), dict(leaves))
    return module


def _config_entry(hook, name: str) -> Entry:
    return Entry("config", (), lambda: np.asarray(getattr(hook, name), np.float32),
                 lambda path, v: setattr(hook, name, float(v)))


def _config_element_entry(hook, name: str, index: int) -> Entry:
    def write(path, v):
        values = list(getattr(hook, name))
        values[index] = float(v)
        setattr(hook, name, tuple(values))

    return Entry("config", (), lambda: np.asarray(getattr(hook, name)[index], np.float32), write)


def _config_entries(hook, prefix: str) -> dict[str, Entry]:
    entries = {}
    for name in hook.jax_config_fields:
        value = getattr(hook, name, None)
        if isinstance(value, (tuple, list)):
            entries.update({f"{prefix}{name}.{i}": _config_element_entry(hook, name, i) for i in range(len(value))})
        elif value is not None:
            entries[f"{prefix}{name}"] = _config_entry(hook, name)
    for index, stage_hook in enumerate(getattr(hook, "stage_hooks", ())):
        entries.update(_config_entries(stage_hook, f"{prefix}stage_hooks.{index}."))
    return entries


def _state_of(optimizer: torch.optim.Optimizer, p: torch.Tensor, key: str, group: dict) -> torch.Tensor:
    """``optimizer.state[p][key]``, created as the optimizer creates it at its
    first step when the parameter has not stepped yet."""
    state = optimizer.state[p]
    if key not in state:
        if key == "step":
            on_device = group.get("capturable") or group.get("fused") or not isinstance(optimizer, torch.optim.Adam)
            state[key] = torch.zeros((), dtype=torch.float32, device=p.device if on_device else "cpu")
        else:
            state[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state[key]


def _moment_entry(optimizer, p: torch.Tensor, key: str, group: dict) -> Entry:
    shard = getattr(p, "tp_shard", None)
    shape = tuple(p.shape) if shard is None else shard.full_shape

    def read():
        state = optimizer.state[p]
        if key not in state:
            return np.zeros(shape, np.float32)
        return to_numpy(state[key] if shard is None else shard.gather(state[key]))

    def write(path, v):
        _copy(path, _state_of(optimizer, p, key, group), v if shard is None else shard.take(np.asarray(v)))

    return Entry("optimizer", shape, read, write)


def _count_entry(optimizer, params: list, group: dict) -> Entry:
    def read():
        steps = [float(optimizer.state[p]["step"]) for p in params if "step" in optimizer.state[p]]
        return np.asarray(max(steps, default=0.0)).astype(np.int32)

    def write(path, v):
        for p in params:
            _state_of(optimizer, p, "step", group).fill_(float(v))

    return Entry("optimizer", (), read, write)


# optax's state per family: (inner prefix, {jax field: torch state key}); Adam's count is apart.
_FAMILY_STATE = {
    "adam": ("", {"mu": "exp_avg", "nu": "exp_avg_sq"}),
    "adamw": ("0.", {"mu": "exp_avg", "nu": "exp_avg_sq"}),
    "rmsprop": ("", {"nu": "square_avg"}),
}


def _optimizer_entries(wrapper, named: dict[str, torch.Tensor]) -> dict[str, Entry]:
    from cusrl_tpu_torch.template.optimizer import PackedAdam

    optimizer = wrapper.optimizer
    path_of = {id(p): path for path, p in named.items()}
    entries: dict[str, Entry] = {}
    if isinstance(optimizer, PackedAdam):
        count = optimizer._count
        entries["opt_state.count"] = Entry("optimizer", (), lambda: np.asarray(float(count)).astype(np.int32),
                                           lambda path, v: count.fill_(float(v)))
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for p in optimizer._params:
                entries[f"opt_state.{field}.{path_of[id(p)]}"] = _moment_entry(optimizer, p, key, {})
        return entries
    for index, group in enumerate(optimizer.param_groups):
        family = group.get("family", "adam")
        params = sorted(group["params"], key=lambda p: path_of[id(p)])
        prefix = f"opt_state.{index}.inner_state."
        if family == "sgd":
            fields = {"trace": "momentum_buffer"} if group["momentum"] else {}
        else:
            inner, fields = _FAMILY_STATE[family]
            prefix += inner
            if family != "rmsprop":
                entries[prefix + "count"] = _count_entry(optimizer, params, group)
        for field, key in fields.items():
            for p in params:
                entries[f"{prefix}{field}.{path_of[id(p)]}"] = _moment_entry(optimizer, p, key, group)
    return entries


def _learning_rate_entry(wrapper, name: str) -> Entry:
    return Entry("learning_rate", (), lambda: np.asarray(float(wrapper.group(name)["lr"]), np.float32),
                 lambda path, v: wrapper.set_learning_rate(name, float(v)))


def _jax_parameter_path(path: str, index_of: dict[str, int]) -> str:
    if path.startswith("hooks."):  # hooks.<hook_name>.<module>... -> hooks.<index>.<module>...
        _, name, rest = path.split(".", 2)
        return f"hooks.{index_of[name]}.{rest}"
    return path


def jax_only_fields(hook) -> tuple[str, ...]:
    return JAX_ONLY_FIELDS.get(type(hook).__name__, ())


def state_entries(agent) -> dict[str, Entry]:
    """Every leaf of the agent's state by its JAX path (the module says which)."""
    index_of = {hook.hook_name: index for index, hook in enumerate(agent.hooks)}
    named = dict(agent.model.named_parameters())
    entries = {_jax_parameter_path(path, index_of): e for path, e in parameter_entries(agent.model).items()}
    trainable = {k: v for k, v in named.items() if v.requires_grad}
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            entries[f"hooks.{index}.{name}"] = _tensor_entry("state", tensor)
        entries.update(_config_entries(hook, f"hooks.{index}."))
        stage = getattr(hook, "stage_optimizer", None)
        if stage is not None:
            entries.update({f"hooks.{index}.{path}": e for path, e in _optimizer_entries(stage, trainable).items()})
            for name in stage.group_names:
                entries[f"hooks.{index}.stage_learning_rates.{name}"] = _learning_rate_entry(stage, name)
    entries.update(_optimizer_entries(agent.optimizer, trainable))
    for name in agent.optimizer.group_names:
        entries[f"learning_rates.{name}"] = _learning_rate_entry(agent.optimizer, name)
    entries["iteration"] = Entry("iteration", (), lambda: np.asarray(agent.iteration, np.int32),
                                 lambda path, v: agent.set_iteration(int(v)))
    return entries


def _load_tree(what: str, targets: dict[str, Entry], given: dict) -> None:
    missing = sorted(set(targets) - set(given))
    extra = sorted(set(given) - set(targets))
    if missing or extra:
        raise KeyError(f"{what} differs: missing {missing}, extra {extra}")
    for path, entry in targets.items():
        entry.write(path, given[path])


def _memory_entries(memory) -> dict[str, Entry]:
    return {path: _tensor_entry("memory", leaf) for path, leaf in flatten_nested(memory).items()}


@torch.no_grad()
def load_jax_state(agent, agent_state: Mapping[str, np.ndarray], actor_memory=None) -> None:
    """Copies every parameter and every stateful hook's state (and
    ``actor_memory`` when given); raises on a missing or extra path or a
    shape mismatch."""
    entries = state_entries(agent)
    kinds = {path: entry.kind for path, entry in entries.items()}
    module_prefixes = tuple(f"hooks.{index}.{module}." for index, hook in enumerate(agent.hooks)
                            for module in hook.owned_modules())
    _load_tree("parameter paths", {p: e for p, e in entries.items() if e.kind == "parameter"},
               {p: v for p, v in agent_state.items()
                if p.startswith(_PARAMETER_PREFIXES + module_prefixes) and kinds.get(p, "parameter") == "parameter"})
    if actor_memory is not None:
        if agent.actor_memory is None:
            raise ValueError("actor_memory given for an actor without memory")
        _load_tree("actor memory", _memory_entries(agent.actor_memory), flatten_nested(actor_memory))
    for index, hook in enumerate(agent.hooks):
        prefix = f"hooks.{index}."
        targets = {p[len(prefix):]: e for p, e in entries.items() if e.kind == "state" and p.startswith(prefix)}
        if not targets:
            continue
        skip = set(hook.jax_config_fields) | set(jax_only_fields(hook))
        given = {p[len(prefix):]: v for p, v in agent_state.items()
                 if p.startswith(prefix) and p[len(prefix):].split(".")[0] not in skip
                 and kinds.get(p, "state") == "state"}
        _load_tree(f"state of hook {index} ('{hook.hook_name}')", targets, given)


def _load_tolerant(agent, entries: dict[str, Entry], saved: Mapping[str, Any], ignored: set, what: str) -> None:
    for path, entry in entries.items():
        if path not in saved:
            agent.warn(f"No checkpoint entry for '{path}'; keeping initialization.")
            continue
        value = np.asarray(saved[path])
        if tuple(value.shape) != entry.shape:
            agent.warn(f"Shape mismatch for '{path}': ckpt {value.shape} vs model {entry.shape}; skipped.")
            continue
        entry.write(path, value)
    unused = sorted(set(saved) - set(entries) - ignored)
    if unused:
        agent.warn(f"Unused {what} keys: {unused[:8]}{'...' if len(unused) > 8 else ''}")


@torch.no_grad()
def load_agent_state(agent, agent_state: Mapping[str, Any], actor_memory=None) -> None:
    """The checkpoint's tolerant loader (the module says how it warns)."""
    ignored = {f"hooks.{index}.{name}" for index, hook in enumerate(agent.hooks) for name in jax_only_fields(hook)}
    _load_tolerant(agent, state_entries(agent), agent_state, ignored, "checkpoint")
    if actor_memory is not None and agent.actor_memory is not None:
        _load_tolerant(agent, _memory_entries(agent.actor_memory), flatten_nested(actor_memory), set(),
                       "actor memory")


def memory_to_numpy(memory):
    return None if memory is None else map_nested(to_numpy, memory)
