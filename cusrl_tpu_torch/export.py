"""Deployment export (counterpart of ``cusrl_tpu/export.py``).

The actor's deployment graph is an ``ExportGraph``: an ordered composition of
named functions over a dict context, built by ``build_actor_graph`` as
observation normalization (the spec's statistics), then each hook's
``pre_export`` (``ObservationNormalization`` adds its running statistics),
then the deterministic actor (the distribution's mode and the backbone's
output; a recurrent actor also takes ``memory_in`` and gives
``memory_out``), then each hook's ``post_export``, then action
denormalization.  ``ExportGraph.build()`` is an ``nn.Module`` whose
parameters and buffers are CPU copies of the agent's, taken at export.

Formats (``export_agent``):

* ``"torch_export"``: a ``torch.export`` ``ExportedProgram`` saved as
  ``graph.pt2``, the counterpart of ``stablehlo``: a serialised graph that
  loads without this package (``torch.export.load``; ``load_exported_graph``
  wraps it).  Recurrent and transformer actors take the memory as an
  explicit input and output; ``initial_memory.pkl`` holds the memory to
  start from (``ExportedStatefulPolicy``).  Integer memory leaves (a ring's
  cursor) cross the graph's boundary as int32, as the JAX package's do.
* ``"package"``: the pickled CPU actor and the dimensions (``policy.pkl``),
  loaded back with ``load_exported_policy`` (it needs this package).
* ``"onnx"``: through ``torch.onnx``; it needs the ``onnx`` package and
  raises ``ImportError`` without it.

By design the exported graph runs the plain versions of the layers, never
the CUDA kernels: it is traced on the CPU copies, where the kernels do not
apply, so the artifact loads and runs wherever PyTorch does, with no kernel
built (the JAX package exports for ``("cpu", "tpu")`` in the same spirit).
It keeps the actor's compute dtype (bf16 products where the actor has
them), as JAX's ``stablehlo`` does.  Every format writes ``manifest.yaml``
with the JAX package's content (inputs and outputs with shapes and dtypes,
the graph's name, the format, ``is_recurrent``), in YAML's flow style,
which is also JSON: PyYAML reads it, and the port reads it back with
``json``, as the GPU machine has no PyYAML.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from cusrl_tpu_torch.nn.base import reset_memory
from cusrl_tpu_torch.utils.interop import memory_to_numpy
from cusrl_tpu_torch.utils.nest import flatten_nested, map_nested

__all__ = [
    "ExportGraph",
    "ExportedStatefulPolicy",
    "InferencePolicy",
    "InferenceWrapper",
    "build_actor_graph",
    "export_agent",
    "load_exported_graph",
    "load_exported_policy",
]

FORMATS = ("torch_export", "package", "onnx")


def _cpu_copy(module: nn.Module) -> nn.Module:
    """A CPU copy, its children renamed where their names shadow an
    ``nn.Module`` attribute (``Sequential``'s ``modules``, the JAX field's
    name): ``torch.export`` reaches submodules with ``getattr``."""
    module = copy.deepcopy(module).cpu().requires_grad_(False).eval()
    for sub in module.modules():
        for name in [n for n in sub._modules if hasattr(nn.Module, n)]:
            sub._modules[f"{name}_"] = sub._modules.pop(name)
    return module


class _Affine(nn.Module):
    """``(x - shift) / scale``, or with ``inverse`` ``x * scale + shift``."""

    def __init__(self, scale_shift: tuple, inverse: bool = False):
        super().__init__()
        scale, shift = (torch.as_tensor(np.asarray(v), dtype=torch.float32) for v in scale_shift)
        self.register_buffer("scale", scale)
        self.register_buffer("shift", shift)
        self.inverse = inverse

    def forward(self, x):
        return x * self.scale + self.shift if self.inverse else (x - self.shift) / self.scale


class ExportGraph:
    """Ordered composition of named functions over a dict context: each node
    reads its inputs from the context by name, writes its outputs back, and
    may expose them as graph results.  ``add_module`` registers a CPU copy of
    a module the nodes call, so its tensors become the graph's."""

    def __init__(self, graph_name: str = "actor"):
        self.graph_name = graph_name
        self.nodes: list[tuple[str, Callable, dict[str, str], tuple[str, ...], bool, dict]] = []
        self.modules = nn.ModuleDict()

    def add_module(self, name: str, module: nn.Module) -> nn.Module:
        self.modules[name.replace(".", "_")] = copy_ = _cpu_copy(module)
        return copy_

    def add_node(self, name: str, fn: Callable[..., Any], inputs: dict[str, str], outputs: tuple[str, ...] | str,
                 expose_outputs: bool = False, info: dict | None = None) -> None:
        if isinstance(outputs, str):
            outputs = (outputs,)
        self.nodes.append((name, fn, dict(inputs), tuple(outputs), expose_outputs, info or {}))

    def add_normalization(self, name: str, normalizer, input_name: str) -> None:
        """A normalization node from a ``RunningMeanStd`` (its ``normalize``)
        or a ``(scale, shift)`` pair."""
        module = self.add_module(name, _Affine(normalizer) if isinstance(normalizer, tuple) else normalizer)
        self.add_node(name, module, {"x": input_name}, (input_name,))

    def add_denormalization(self, name: str, scale_shift: tuple, input_name: str) -> None:
        self.add_node(name, self.add_module(name, _Affine(scale_shift, inverse=True)), {"x": input_name},
                      (input_name,))

    def add_head(self, name: str, module: nn.Module, input_name: str, extra_inputs: tuple[str, ...] = ()) -> None:
        """An exposed head fed by a latent (plus extra inputs, concatenated)."""
        head = self.add_module(name, module)

        def fn(*arrays):
            return head(arrays[0] if len(arrays) == 1 else torch.cat(arrays, dim=-1))

        inputs = {f"arg{i}": n for i, n in enumerate((input_name, *extra_inputs))}
        self.add_node(name, fn, inputs, (name,), expose_outputs=True)

    @property
    def exposed_outputs(self) -> list[str]:
        exposed: list[str] = []
        for _, _, _, outputs, expose, _ in self.nodes:
            if expose:
                exposed.extend(o for o in outputs if o not in exposed)
        return exposed

    def build(self) -> nn.Module:
        """The graph as a module: ``context -> {exposed outputs}``."""
        return _GraphModule(self)


class _GraphModule(nn.Module):
    def __init__(self, graph: ExportGraph):
        super().__init__()
        self.graph_modules = graph.modules
        self._nodes = list(graph.nodes)
        self._names = ["action", *graph.exposed_outputs]

    def forward(self, context: dict[str, Any]) -> dict[str, Any]:
        context = dict(context)
        for _, fn, inputs, outputs, _, _ in self._nodes:
            result = fn(*[context[src] for src in inputs.values()])
            if len(outputs) == 1:
                result = (result,)
            context.update(zip(outputs, result))
        return {name: context[name] for name in dict.fromkeys(self._names) if name in context}


def _boundary_memory(memory):
    """A memory as it crosses the graph's boundary: int64 leaves as int32."""
    return map_nested(lambda t: t.to(torch.int32) if t.dtype == torch.int64 else t, memory)


def build_actor_graph(agent, with_environment_normalization: bool = True) -> ExportGraph:
    """Normalization -> hooks' pre_export -> deterministic actor -> hooks'
    post_export -> action denormalization."""
    graph = ExportGraph("actor")
    spec = agent.environment_spec
    if with_environment_normalization and spec.observation_normalization is not None:
        graph.add_normalization("observation_normalization", tuple(spec.observation_normalization), "observation")
    for hook in agent.hooks:
        hook.pre_export(agent, graph)
    actor = graph.add_module("actor", agent.actor)
    info = {"observation_dim": spec.observation_dim, "action_dim": spec.action_dim, "is_recurrent": actor.is_recurrent}
    if actor.is_recurrent:
        dtypes = map_nested(lambda t: t.dtype, actor.init_memory(1))

        def actor_fn(observation, memory):
            memory = _cast_like(memory, dtypes)  # int32 at the boundary, the actor's own dtypes inside
            dist_params, new_memory, aux = actor(observation, memory)
            return actor.distribution.mode(dist_params), aux["backbone.output"], _boundary_memory(new_memory)

        graph.add_node("actor", actor_fn, {"observation": "observation", "memory": "memory_in"},
                       ("action", "actor.backbone.output", "memory_out"), expose_outputs=True, info=info)
    else:

        def actor_fn(observation):
            dist_params, _, aux = actor(observation, None)
            return actor.distribution.mode(dist_params), aux["backbone.output"]

        graph.add_node("actor", actor_fn, {"observation": "observation"}, ("action", "actor.backbone.output"),
                       expose_outputs=True, info=info)
    for hook in agent.hooks:
        hook.post_export(agent, graph)
    if with_environment_normalization and spec.action_denormalization is not None:
        graph.add_denormalization("action_denormalization", tuple(spec.action_denormalization), "action")
    return graph


def _cast_like(memory, dtypes):
    if isinstance(memory, dict):
        return {key: _cast_like(value, dtypes[key]) for key, value in memory.items()}
    return memory.to(dtypes)


def _describe(tree) -> dict:
    return {name: {"shape": [int(s) for s in leaf.shape], "dtype": str(leaf.dtype).removeprefix("torch.")}
            for name, leaf in flatten_nested(tree).items()}


def _write_manifest(path: str, inputs: dict, outputs: dict, extra: dict) -> None:
    manifest = {"inputs": _describe(inputs), "outputs": _describe(outputs), **extra}
    with open(os.path.join(path, "manifest.yaml"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.yaml")) as f:
        return json.load(f)


def export_agent(agent, output_dir: str, *, target_format: str = "torch_export",
                 with_environment_normalization: bool = True, batch_size: int = 1, verbose: bool = True) -> None:
    if target_format not in FORMATS:
        raise ValueError(f"Unsupported export format '{target_format}' (available: {FORMATS})")
    if target_format == "onnx":
        try:
            import onnx  # noqa: F401
        except ImportError as error:
            raise ImportError("onnx export requires the 'onnx' package; the first-class deployment format is "
                              "'torch_export'") from error
    os.makedirs(output_dir, exist_ok=True)
    graph = build_actor_graph(agent, with_environment_normalization)
    module = graph.build()
    actor = graph.modules["actor"]
    spec = agent.environment_spec
    example: dict[str, Any] = {"observation": torch.zeros(batch_size, spec.observation_dim)}
    if actor.is_recurrent:
        example["memory_in"] = _boundary_memory(actor.init_memory(batch_size))
    with torch.no_grad():
        outputs = module(example)
    _write_manifest(output_dir, example, outputs,
                    {"graph": graph.graph_name, "format": target_format, "is_recurrent": actor.is_recurrent})

    if target_format == "torch_export":
        program = torch.export.export(module, (example,))
        torch.export.save(program, os.path.join(output_dir, "graph.pt2"))
        if actor.is_recurrent:
            with open(os.path.join(output_dir, "initial_memory.pkl"), "wb") as f:
                pickle.dump(memory_to_numpy(example["memory_in"]), f)
    elif target_format == "package":
        payload = {"actor": actor, "observation_dim": spec.observation_dim, "action_dim": spec.action_dim}
        with open(os.path.join(output_dir, "policy.pkl"), "wb") as f:
            pickle.dump(payload, f)
    else:
        torch.onnx.export(module, (example,), os.path.join(output_dir, "graph.onnx"), dynamo=True)
    if verbose:
        print(f"Agent exported to {output_dir} in '{target_format}' format.")


def load_exported_policy(path: str) -> nn.Module:
    """The actor of a ``package``-format export."""
    if os.path.isdir(path):
        path = os.path.join(path, "policy.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)["actor"]


def load_exported_graph(path: str, device: str | torch.device | None = None):
    """A ``torch_export`` directory as ``(call, manifest)``: ``call(context)
    -> outputs`` runs the program, traced on the CPU, or moved to ``device``
    (its weights and the devices its ops name, ``move_to_device_pass``)."""
    from torch.export.passes import move_to_device_pass

    program = torch.export.load(os.path.join(path, "graph.pt2"))
    if device is not None:
        program = move_to_device_pass(program, torch.device(device))
    return program.module(), _read_manifest(path)


class InferencePolicy:
    """Stateful inference around an actor: holds a recurrent memory,
    keeps numpy IO, adds the batch dim to a single observation and supports
    ``reset(indices)``; actions are the distribution's mode."""

    def __init__(self, actor, num_instances: int = 1, deterministic: bool = True):
        if not deterministic:
            raise NotImplementedError("InferencePolicy samples no actions: it returns the mode")
        self.actor = actor
        self.num_instances = num_instances
        self.deterministic = deterministic
        self.memory = actor.init_memory(num_instances) if actor.is_recurrent else None

    @torch.no_grad()
    def __call__(self, observation):
        was_numpy = isinstance(observation, np.ndarray)
        device = next(self.actor.parameters()).device
        observation = torch.as_tensor(observation, dtype=torch.float32, device=device)
        squeeze = observation.dim() == 1
        if squeeze:
            observation = observation[None]
        dist_params, self.memory, _ = self.actor(observation, self.memory)
        action = self.actor.distribution.mode(dist_params)
        action = action[0] if squeeze else action
        return action.cpu().numpy() if was_numpy else action

    def reset(self, indices=None) -> None:
        if self.memory is None:
            return
        if indices is None:
            self.memory = self.actor.init_memory(self.num_instances)
            return
        device = next(self.actor.parameters()).device
        done = torch.zeros(self.num_instances, 1, dtype=torch.bool, device=device)
        done[torch.as_tensor(np.asarray(indices), device=device)] = True
        self.memory = reset_memory(self.memory, done)


InferenceWrapper = InferencePolicy


class ExportedStatefulPolicy:
    """A recurrent ``torch_export`` artifact as a stateful policy: the graph
    plus ``initial_memory.pkl``; memory held internally, numpy IO,
    ``reset(indices)`` puts the initial memory back where asked."""

    def __init__(self, path: str, device: str | torch.device | None = None):
        self.call, self.manifest = load_exported_graph(path, device)
        if not self.manifest.get("is_recurrent"):
            raise ValueError(f"'{path}' is a stateless export; use load_exported_graph")
        self.device = torch.device("cpu" if device is None else device)
        dtypes = {name[len("memory_in."):]: info["dtype"] for name, info in self.manifest["inputs"].items()
                  if name.startswith("memory_in.")}
        with open(os.path.join(path, "initial_memory.pkl"), "rb") as f:
            initial = pickle.load(f)
        self._initial_memory = _unflatten({name: torch.as_tensor(np.asarray(leaf)).to(self.device, getattr(
            torch, dtypes[name])) for name, leaf in flatten_nested(initial).items()})
        self.memory = self._initial_memory
        self.num_instances = int(self.manifest["inputs"]["observation"]["shape"][0])

    @torch.no_grad()
    def __call__(self, observation):
        was_numpy = isinstance(observation, np.ndarray)
        observation = torch.as_tensor(observation, dtype=torch.float32, device=self.device)
        squeeze = observation.dim() == 1
        if squeeze:
            observation = observation[None]
        outputs = self.call({"observation": observation, "memory_in": self.memory})
        self.memory = outputs.pop("memory_out")
        action = outputs["action"][0] if squeeze else outputs["action"]
        return action.cpu().numpy() if was_numpy else action

    def reset(self, indices=None) -> None:
        if indices is None:
            self.memory = self._initial_memory
            return
        done = torch.zeros(self.num_instances, dtype=torch.bool, device=self.device)
        done[torch.as_tensor(np.asarray(indices), device=self.device)] = True
        self.memory = _where_nested(done, self._initial_memory, self.memory)


def _unflatten(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _where_nested(mask, initial, memory):
    if isinstance(memory, dict):
        return {key: _where_nested(mask, initial[key], value) for key, value in memory.items()}
    if memory.dim() == 0:
        return memory
    return torch.where(mask.reshape(mask.shape[:1] + (1,) * (memory.dim() - 1)), initial, memory)
