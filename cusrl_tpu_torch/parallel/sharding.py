"""Placement on a mesh of processes (counterpart of
``cusrl_tpu/parallel/sharding.py``).

The JAX package places the agent's state on a ``(data, model)`` device mesh
(``(dcn, data, model)`` on hierarchical meshes) and lets XLA insert the
collectives.  Here a mesh is made of process groups, one device per process.
``get_mesh`` lays the ranks out as JAX lays out devices, row-major with the
model axis fastest: ``rank = (dcn_i * D + data_i) * M + model_i``, so model
peers are adjacent ranks (one host).  A 1-D data mesh (``M = K = 1``) is the
default process group itself; any other is a ``ProcessMesh`` with the groups
``data`` (the ranks that share a model coordinate: the batch axis, ``dcn``
and ``data`` together), ``model`` (the ranks that share a data coordinate)
and, on a hierarchical mesh, ``ici`` (one ``dcn`` index's data ranks) and
``dcn`` (one data index's ranks across ``dcn``) for the two-level gradient
reduce.  Every function that takes a group also takes the mesh.

``replicate`` broadcasts rank 0's tensors over the whole mesh, ``shard_batch``
keeps the process's part of a batch over the data axes (model peers keep the
same rows), and ``distribute_agent`` broadcasts rank 0's agent state and
marks the agent distributed: its ``process_group`` is the data group, over
which its rollout statistics and updates are global
(``parallel.multiprocess``).  With ``tensor_parallel=True`` on a mesh whose
model axis is larger than one, every parameter that a module's ``tp_specs``
shards (only ``Mlp`` declares any: Megatron-style, even layers split their
output dimension, odd layers their input dimension) is narrowed to this
rank's part (``parallel/tensor.py``); a leaf whose dimension does not divide
over ``model`` stays whole, with JAX's warning.  ``collect_tp_specs`` gives
the declared specs by parameter path (``utils/interop.py`` maps them to
JAX's), ``tensor_parallel_rules`` JAX's deprecated regex list.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from cusrl_tpu_torch.parallel.multiprocess import broadcast_agent_state, data_group, process_mesh
from cusrl_tpu_torch.parallel.tensor import shard_parameter
from cusrl_tpu_torch.utils.nest import map_nested

__all__ = [
    "ProcessMesh",
    "collect_tp_specs",
    "data_axes",
    "distribute_agent",
    "get_mesh",
    "replicate",
    "shard_batch",
    "tensor_parallel_rules",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """Process groups laid out as a JAX mesh: ``shape`` maps each of
    ``axis_names`` to its size, ``ranks`` holds the global ranks in that
    shape."""

    axis_names: tuple[str, ...]
    ranks: np.ndarray
    world: Any
    data: Any
    model: Any
    ici: Any = None
    dcn: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def gradient_levels(self) -> dict[str, Any]:
        """The levels a gradient all-reduce runs over, in turn."""
        return {"data": self.data} if self.dcn is None else {"ici": self.ici, "dcn": self.dcn}


def _group_of(members, mine: int):
    """Creates every group of ``members`` (lists of global ranks; a
    collective call: every process creates every group, in the same order)
    and returns the one holding ``mine``."""
    found = None
    for ranks in members:
        ranks = sorted(int(r) for r in ranks)
        group = dist.group.WORLD if len(ranks) == dist.get_world_size() else dist.new_group(ranks)
        if mine in ranks:
            found = group
    return found


def get_mesh(model_parallel_size: int | None = None, ranks=None, dcn_parallel_size: int = 1):
    """A ``(data, model)`` mesh, or ``(dcn, data, model)`` with
    ``dcn_parallel_size > 1``, over every process (``ranks``: their order,
    a permutation of the default group's ranks).  ``model_parallel_size``
    defaults to ``CONFIG.model_parallel_size``.  The 1-D data mesh is the
    default process group; every process must call this with the same
    arguments (the groups are made together)."""
    from cusrl_tpu_torch.utils.config import CONFIG

    model = CONFIG.model_parallel_size if model_parallel_size is None else int(model_parallel_size)
    world = process_mesh()
    size = dist.get_world_size()
    ranks = np.arange(size) if ranks is None else np.asarray(ranks).reshape(-1)
    if sorted(ranks.tolist()) != list(range(size)):
        raise ValueError(f"ranks {ranks.tolist()} are not a permutation of the {size} processes")
    if size % (model * dcn_parallel_size) != 0:
        raise ValueError(f"{size} processes not divisible by model_parallel_size={model}"
                         f" x dcn_parallel_size={dcn_parallel_size}")
    if model == 1 and dcn_parallel_size == 1:
        return world
    shaped = ranks.reshape(dcn_parallel_size, -1, model)
    mine = dist.get_rank()
    by_model = [shaped[:, :, m].reshape(-1) for m in range(model)]
    by_data = [shaped[k, d, :] for k in range(shaped.shape[0]) for d in range(shaped.shape[1])]
    groups = dict(world=world, data=_group_of(by_model, mine), model=_group_of(by_data, mine))
    if dcn_parallel_size > 1:
        groups["ici"] = _group_of([shaped[k, :, m] for k in range(shaped.shape[0]) for m in range(model)], mine)
        groups["dcn"] = _group_of([shaped[:, d, m] for d in range(shaped.shape[1]) for m in range(model)], mine)
        return ProcessMesh(("dcn", "data", "model"), shaped, **groups)
    return ProcessMesh(("data", "model"), shaped[0], **groups)


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes: ``("dcn", "data")`` on hierarchical meshes,
    ``("data",)`` otherwise."""
    return ("dcn", "data") if "dcn" in getattr(mesh, "axis_names", ()) else ("data",)


@torch.no_grad()
def replicate(tree: Any, mesh=None) -> Any:
    """Every tensor leaf of ``tree`` replaced, in place, by rank 0's (over
    every process of the mesh)."""
    group = mesh.world if isinstance(mesh, ProcessMesh) else mesh or process_mesh()
    source = dist.get_global_rank(group, 0)

    def broadcast(leaf):
        dist.broadcast(leaf, source, group=group)
        return leaf

    return map_nested(broadcast, tree)


def shard_batch(tree: Any, mesh=None, axis: int = 0) -> Any:
    """This process's part of every tensor leaf along ``axis`` over the data
    axes (equal parts, the first data ranks one more where the length does
    not divide; model peers get the same part)."""
    group = data_group(mesh or process_mesh())
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    return map_nested(lambda leaf: torch.tensor_split(leaf, world, dim=axis)[rank], tree)


def collect_tp_specs(tree) -> dict[str, tuple]:
    """The partition specs the modules of ``tree`` (an agent: its ``model``;
    or any ``nn.Module``) declare through ``tp_specs()``, by parameter path
    (``"model"`` names the model axis, ``None`` a whole dimension).  A
    child's declaration extends, and on conflict overrides, its ancestors'."""
    module = getattr(tree, "model", tree)
    specs: dict[str, tuple] = {}
    for prefix, child in module.named_modules():
        declare = getattr(child, "tp_specs", None)
        if callable(declare):
            for relative, spec in declare().items():
                specs[f"{prefix}.{relative}" if prefix else relative] = tuple(spec)
    return specs


def tensor_parallel_rules() -> list[tuple[str, tuple]]:
    """Deprecated regex fallback, kept for API compatibility: module-declared
    specs (``collect_tp_specs``) are what ``distribute_agent`` consumes."""
    rules: list[tuple[str, tuple]] = []
    for layer in range(0, 64, 2):
        rules.append((rf".*\.layers\.{layer}\.weight$", ("model", None)))
        rules.append((rf".*\.layers\.{layer}\.bias$", ("model",)))
    for layer in range(1, 64, 2):
        rules.append((rf".*\.layers\.{layer}\.weight$", (None, "model")))
    return rules


def _apply_specs(agent, mesh: ProcessMesh, specs: dict[str, tuple]) -> list[str]:
    """Narrows every parameter whose spec divides over ``model`` to this
    rank's part, with the optimizers' state of the same shape; a leaf whose
    spec does not divide stays whole, with JAX's warning.  Returns the
    sharded paths."""
    model = mesh.shape["model"]
    sharded = []
    for path, parameter in agent.model.named_parameters():
        spec = specs.get(path)
        if spec is None:
            continue
        dims = [dim for dim, name in enumerate(spec) if name is not None]
        if any(dim >= parameter.dim() or parameter.shape[dim] % model for dim in dims):
            warnings.warn(f"tensor-parallel spec {spec} for '{path}' (shape {tuple(parameter.shape)}) "
                          f"does not divide over model={model}; leaving replicated")
            continue
        (dim,) = dims
        full = tuple(parameter.shape)
        shard = shard_parameter(parameter, dim, mesh.model)
        for _, optimizer in agent._optimizers():
            state = optimizer.state.get(parameter, {})
            for key, value in state.items():
                if isinstance(value, torch.Tensor) and tuple(value.shape) == full:
                    state[key] = shard.take(value).contiguous()
        sharded.append(path)
    for _, optimizer in agent._optimizers():
        if sharded and hasattr(optimizer, "repack"):  # PackedAdam's flat moments
            optimizer.repack()
    return sharded


def distribute_agent(agent, mesh=None, tensor_parallel: bool = False):
    """Broadcasts rank 0's agent state to every process and marks the agent
    distributed: its ``process_group`` is the mesh's data group (the batch
    axis), ``mesh`` the mesh and ``model_group`` the model group; from then
    on its rollout statistics and updates are global over the data axes.
    Model peers then share the action noise generator (the first model
    rank's), so they step the same environments with the same draws.  With
    ``tensor_parallel`` and a model axis larger than one the ``Mlp``
    modules are sharded over it (the module docstring says how), and their
    layers run plain, without the fused MLP chain kernels (announced once a
    process).  Returns the mesh."""
    mesh = mesh or get_mesh()
    is_mesh = isinstance(mesh, ProcessMesh)
    agent.process_group = data_group(mesh)
    agent.mesh = mesh if is_mesh else None
    agent.model_group = mesh.model if is_mesh else None
    broadcast_agent_state(agent, mesh)
    if not is_mesh or mesh.shape["model"] == 1:
        return mesh
    holder = [agent.generator.get_state()]
    dist.broadcast_object_list(holder, src=dist.get_global_rank(mesh.model, 0), group=mesh.model)
    agent.generator.set_state(holder[0])
    if tensor_parallel:
        if _apply_specs(agent, mesh, collect_tp_specs(agent)):
            from cusrl_tpu_torch.nn.kernels.fused_mlp import warn_tensor_parallel

            warn_tensor_parallel(mesh.shape)
    return mesh
