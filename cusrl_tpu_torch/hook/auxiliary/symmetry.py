"""Symmetry suite (counterpart of ``cusrl_tpu/hook/auxiliary/symmetry.py``).

* ``MirrorDef``: gather by ``destination_indices``, then negate
  ``flipped_indices``.
* ``TransitionMirroring``: the actor sees the mirrored inputs and the
  rollout stores the mirrored transition.
* ``MirrorSymmetryLoss``: MSE between ``policy(obs)`` and
  ``mirror(policy(mirror(obs)))``; a recurrent actor's mirrored memory is
  stepped alongside the rollout.
* ``SymmetricDataAugmentation``: the mirrored transitions stacked on a new
  augmentation axis, ``[..., K+1, C]``, so the update's batch grows (K+1)-fold;
  ``action_logp``, ``advantage``, ``value`` and ``return`` are repeated on
  that axis (axis 2 under a temporal sampler).  Feedforward backbones map any
  leading dimensions row by row, and the joint evaluation flattens them.
  With joint evaluation it must come before it (``before=
  "joint_policy_value_evaluation"``): placed after it, the losses meet the
  un-augmented evaluation and fail to broadcast, as in the JAX package.
* ``SymmetricArchitecture`` / ``SymmetricActor``: a strictly symmetric
  policy averaging the original and the mirrored pass.

A mirror maps ``[..., C] -> [..., C]`` (one variant) or ``[K, ..., C]`` (K
variants).  The memories the rollout replays are recorded as of the
rollout's first step (``rollout_memory_entries``), or per step under a
sampler with ``requires_per_step_memory``, as the actor's are.
"""

from __future__ import annotations

import numpy as np
import torch

from cusrl_tpu_torch.nn.base import reset_memory, storable_memory
from cusrl_tpu_torch.nn.module.actor import Actor
from cusrl_tpu_torch.nn.module.distribution import NormalDist
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import flatten_nested, map_nested, stack_nested

__all__ = [
    "MirrorDef",
    "MirrorSymmetryLoss",
    "SymmetricActor",
    "SymmetricArchitecture",
    "SymmetricDataAugmentation",
    "TransitionMirroring",
]


class MirrorDef:
    """``x[..., destination_indices]`` with ``flipped_indices`` negated."""

    def __init__(self, destination_indices, flipped_indices):
        self.destination_indices = tuple(int(i) for i in destination_indices)
        self.flipped_indices = tuple(int(i) for i in flipped_indices)
        self._operands = {}

    def _device_operands(self, device, dtype):
        """The index and the signs on ``device``, made once per device and
        dtype (a fresh host-to-device copy per call would wait on the device)."""
        key = (str(device), dtype)
        if key not in self._operands:
            multiplier = np.ones(len(self.destination_indices), np.float32)
            multiplier[list(self.flipped_indices)] = -1.0
            self._operands[key] = (torch.tensor(self.destination_indices, dtype=torch.long, device=device),
                                   torch.tensor(multiplier, dtype=dtype, device=device))
        return self._operands[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        index, multiplier = self._device_operands(x.device, x.dtype)
        return x.index_select(-1, index) * multiplier

    def __getstate__(self):
        return {"destination_indices": self.destination_indices, "flipped_indices": self.flipped_indices}

    def __setstate__(self, state):
        self.__init__(state["destination_indices"], state["flipped_indices"])

    def __hash__(self):
        return hash((self.destination_indices, self.flipped_indices))

    def __eq__(self, other):
        return (isinstance(other, MirrorDef) and self.destination_indices == other.destination_indices
                and self.flipped_indices == other.flipped_indices)

    def __repr__(self):
        return f"MirrorDef(destination_indices={self.destination_indices}, flipped_indices={self.flipped_indices})"


def _mirror_variants(x: torch.Tensor, mirror) -> torch.Tensor:
    """The mirrored variants of ``x``, ``[K, ...x's shape...]``."""
    mirrored = mirror(x)
    if mirrored.shape == x.shape:
        return mirrored[None]
    if mirrored.shape[1:] == x.shape:
        return mirrored
    raise ValueError(f"Mirror returned incompatible shape {tuple(mirrored.shape)} for input {tuple(x.shape)}")


def _on_device(memory, device):
    return map_nested(lambda t: t.to(device), memory)


class _SymmetryHook(Hook):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.mirror_observation = self.mirror_state = self.mirror_action = None

    def init(self, agent) -> None:
        spec = agent.environment_spec
        if spec.mirror_observation is None:
            raise ValueError("'mirror_observation' must be defined for symmetry hooks")
        if spec.has_state and spec.mirror_state is None:
            raise ValueError("'mirror_state' must be defined for symmetry hooks")
        if spec.mirror_action is None:
            raise ValueError("'mirror_action' must be defined for symmetry hooks")
        self.mirror_observation, self.mirror_state = spec.mirror_observation, spec.mirror_state
        self.mirror_action = spec.mirror_action


class TransitionMirroring(_SymmetryHook):
    """The actor sees mirrored inputs and the stored transitions are the
    mirrored variant ``index``; the mirror must be its own inverse (actions
    map back with it)."""

    def __init__(self, index: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.index = index

    def _mirror(self, transition: dict, key: str, mirror) -> None:
        if transition.get(key) is not None:
            transition[key] = _mirror_variants(transition[key], mirror)[self.index]

    def pre_act(self, agent, transition: dict) -> None:
        self._mirror(transition, "observation", self.mirror_observation)
        self._mirror(transition, "state", self.mirror_state)

    def post_act(self, agent, transition: dict) -> None:
        self._mirror(transition, "action", self.mirror_action)

    def post_step(self, agent, transition: dict) -> None:
        self._mirror(transition, "next_observation", self.mirror_observation)
        self._mirror(transition, "next_state", self.mirror_state)


class MirrorSymmetryLoss(_SymmetryHook):
    """``policy(obs)`` must equal ``mirror(policy(mirror(obs)))`` in the mean
    (and, with ``symmetrize_action_std``, in the std)."""

    jax_config_fields = ("weight",)
    batch_keys = ("observation", "mirrored_actor_memory", "done")

    def __init__(self, weight: float | None = 1.0, symmetrize_action_std: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.weight = weight
        self.symmetrize_action_std = symmetrize_action_std
        self.mirrored_memory = None

    def init(self, agent) -> None:
        super().init(agent)
        if agent.actor.is_recurrent:
            self.mirrored_memory = _on_device(agent.actor.init_memory(agent.parallelism), agent.device)

    def state_tensors(self) -> dict:
        return {} if self.mirrored_memory is None else flatten_nested(self.mirrored_memory, "mirrored_memory")

    def rollout_memory_entries(self) -> dict:
        return {} if self.mirrored_memory is None else {"mirrored_actor_memory": self.mirrored_memory}

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        if self.mirrored_memory is None:
            return
        mirrored_observation = _mirror_variants(transition["observation"], self.mirror_observation)[0]
        if agent.records_per_step_memory:
            transition["mirrored_actor_memory"] = storable_memory(self.mirrored_memory,
                                                                  mirrored_observation.shape[0])
        _, new_memory, _ = agent.actor.backbone(mirrored_observation, self.mirrored_memory)
        self.mirrored_memory = reset_memory(new_memory, transition["done"])

    def objective(self, agent, metadata, batch):
        if self.weight is None:
            return None, {}
        memory = batch.get("mirrored_actor_memory")
        temporal = metadata.get("temporal", False)
        if temporal and memory is not None:
            memory = map_nested(lambda m: m[0], memory)
        mirrored_observation = _mirror_variants(batch["observation"], self.mirror_observation)[0]
        mirrored_dist, _, _ = agent.actor(mirrored_observation, memory, sequential=temporal, done=batch.get("done"))
        curr = batch["curr_action_dist"]
        mean_target = _mirror_variants(mirrored_dist["mean"], self.mirror_action)[0]
        losses = {"action_mean_symmetry_loss": (curr["mean"] - mean_target).square().mean() * self.weight}
        if self.symmetrize_action_std:
            std_target = _mirror_variants(mirrored_dist["std"], self.mirror_action)[0].abs()
            losses["action_std_symmetry_loss"] = (curr["std"] - std_target).square().mean() * self.weight
        return losses, {}


def _augment(x: torch.Tensor, mirror):
    """``(variants [K, N, C], [N, K+1, C])``: the original first."""
    variants = _mirror_variants(x, mirror)
    return variants, torch.cat([x[None], variants], 0).movedim(0, 1)


def _augment_memory(original, mirrored, streams: int):
    """``[N, 1+K, ...]`` memory: the original stream, then the mirrored ones.
    Rank-0 leaves (a ring cursor) are global, the same for every stream."""
    def _leaf(orig, mirr):
        if mirr.dim() == 0:
            return orig[:, None].expand(orig.shape[0], streams)
        return torch.cat([orig[:, None], mirr], 1)

    if isinstance(original, dict):
        return {key: _augment_memory(original[key], mirrored[key], streams) for key in original}
    return _leaf(original, mirrored)


def _stack_streams(leaves: list) -> torch.Tensor:
    """Per-stream memory leaves stacked on axis 1; rank-0 leaves are shared."""
    return torch.stack(leaves, 1) if leaves[0].dim() else leaves[0]


def _stream(memory, k: int):
    return map_nested(lambda x: x if x.dim() == 0 else x[:, k], memory)


class SymmetricDataAugmentation(_SymmetryHook):
    """Appends the mirrored transitions on a new augmentation axis; a
    recurrent actor's (and critic's) memories of the mirrored streams are
    stepped alongside the rollout."""

    training_only = True
    batch_keys = ("augmented_observation", "augmented_next_observation", "augmented_action", "augmented_state",
                  "augmented_next_state", "augmented_actor_memory", "augmented_critic_memory", "action_logp",
                  "advantage", "value", "return")

    def __init__(self, augments_value: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.augments_value = augments_value
        self.mirrored_actor_memory = self.mirrored_critic_memory = None
        self._agent = None
        self._num_variants = 1

    def init(self, agent) -> None:
        super().init(agent)
        self._agent = agent
        self._num_variants = _mirror_variants(torch.zeros(1, agent.observation_dim),
                                              self.mirror_observation).shape[0]

        def streams(module):
            memory = module.init_memory(agent.parallelism)
            return _on_device(stack_nested([memory] * self._num_variants, _stack_streams), agent.device)

        if agent.actor.is_recurrent:
            self.mirrored_actor_memory = streams(agent.actor)
        if self.augments_value and agent.critic.is_recurrent:
            self.mirrored_critic_memory = streams(agent.critic)

    def state_tensors(self) -> dict:
        tensors = {}
        for name in ("mirrored_actor_memory", "mirrored_critic_memory"):
            memory = getattr(self, name)
            if memory is not None:
                tensors.update(flatten_nested(memory, name))
        return tensors

    def _critic_memory(self):
        value = next((h for h in self._agent.hooks if h.hook_name == "value_computation"), None)
        return None if value is None else value.memory

    def _augmented_memories(self, actor_memory, critic_memory) -> dict:
        entries = {}
        n, streams = self._agent.parallelism, 1 + self._num_variants
        for name, original, mirrored in (("actor", actor_memory, self.mirrored_actor_memory),
                                         ("critic", critic_memory, self.mirrored_critic_memory)):
            if mirrored is not None and original is not None:
                entries[f"augmented_{name}_memory"] = _augment_memory(storable_memory(original, n), mirrored,
                                                                      streams)
        return entries

    def rollout_memory_entries(self) -> dict:
        if self._agent is None:
            return {}
        return self._augmented_memories(self._agent.actor_memory, self._critic_memory())

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        mirrored_obs, transition["augmented_observation"] = _augment(transition["observation"],
                                                                     self.mirror_observation)
        _, transition["augmented_next_observation"] = _augment(transition["next_observation"],
                                                               self.mirror_observation)
        if transition.get("state") is not None:
            mirrored_state, transition["augmented_state"] = _augment(transition["state"], self.mirror_state)
            _, transition["augmented_next_state"] = _augment(transition["next_state"], self.mirror_state)
        else:
            mirrored_state = mirrored_obs
        _, transition["augmented_action"] = _augment(transition["action"], self.mirror_action)
        if agent.records_per_step_memory:
            transition.update(self._augmented_memories(transition.get("actor_memory"),
                                                       transition.get("critic_memory")))
        done = transition["done"]

        def step(module, inputs, memory):
            new = []
            for k in range(inputs.shape[0]):
                _, m, _ = module.backbone(inputs[k], _stream(memory, k))
                new.append(reset_memory(m, done))
            return stack_nested(new, _stack_streams)

        if self.mirrored_actor_memory is not None:
            self.mirrored_actor_memory = step(agent.actor, mirrored_obs, self.mirrored_actor_memory)
        if self.mirrored_critic_memory is not None:
            self.mirrored_critic_memory = step(agent.critic, mirrored_state, self.mirrored_critic_memory)

    def objective(self, agent, metadata, batch):
        batch["observation"] = batch["augmented_observation"]
        batch["next_observation"] = batch["augmented_next_observation"]
        batch["action"] = batch["augmented_action"]
        if "augmented_state" in batch:
            batch["state"] = batch["augmented_state"]
            batch["next_state"] = batch["augmented_next_state"]
        axis = 2 if metadata.get("temporal") else 1
        factor = batch["augmented_observation"].shape[axis]

        def repeat(x):
            x = x.unsqueeze(axis)
            return x.expand(*x.shape[:axis], factor, *x.shape[axis + 1:])

        for key in ("action_logp", "advantage"):
            if batch.get(key) is not None:
                batch[key] = repeat(batch[key])
        if batch.get("augmented_actor_memory") is not None:
            batch["actor_memory"] = batch["augmented_actor_memory"]
        if self.augments_value:
            for key in ("value", "return"):
                batch[key] = repeat(batch[key])
            if batch.get("augmented_critic_memory") is not None:
                batch["critic_memory"] = batch["augmented_critic_memory"]
        return None, {}


class SymmetricArchitecture(_SymmetryHook):
    """Wraps the agent's actor into a strictly symmetric ``SymmetricActor``
    (the same backbone and distribution: the parameter paths stay
    ``actor.backbone.*`` and ``actor.distribution.*``)."""

    def init(self, agent) -> None:
        super().init(agent)
        actor = agent.actor
        if isinstance(actor, SymmetricActor):
            return
        if type(actor.distribution) is not NormalDist:
            raise ValueError("SymmetricActor requires a Normal distribution")
        agent.model["actor"] = SymmetricActor(actor.backbone, actor.distribution, self.mirror_observation,
                                              self.mirror_action)


class SymmetricActor(Actor):
    """Averages the original and the mirrored policy pass: strictly
    symmetric.  A recurrent backbone's memory is ``{"original": ...,
    "mirrored": ...}``."""

    def __init__(self, backbone, distribution, mirror_observation, mirror_action):
        super().__init__(backbone, distribution)
        self.mirror_observation = mirror_observation
        self.mirror_action = mirror_action

    def init_memory(self, batch_size: int):
        if not self.backbone.is_recurrent:
            return None
        return {"original": self.backbone.init_memory(batch_size), "mirrored": self.backbone.init_memory(batch_size)}

    @staticmethod
    def _split_memory(memory):
        return (None, None) if memory is None else (memory["original"], memory["mirrored"])

    @staticmethod
    def _join_memory(original, mirrored):
        return None if original is None else {"original": original, "mirrored": mirrored}

    def _passes(self, observation, memory, **kwargs):
        original_memory, mirrored_memory = self._split_memory(memory)
        mirrored_observation = _mirror_variants(observation, self.mirror_observation)[0]
        orig = self.backbone(observation, original_memory, **kwargs)
        mirr = self.backbone(mirrored_observation, mirrored_memory, **kwargs)
        return orig, mirr, self._join_memory(orig[1], mirr[1])

    def forward(self, observation: torch.Tensor, memory=None, **kwargs):
        (orig_latent, _, orig_aux), (mirr_latent, _, mirr_aux), new_memory = self._passes(observation, memory,
                                                                                          **kwargs)
        orig_dist = self.distribution(orig_latent)
        mirr_dist = self.distribution(mirr_latent)
        dist_params = {
            "mean": (orig_dist["mean"] + _mirror_variants(mirr_dist["mean"], self.mirror_action)[0]) / 2,
            "std": (orig_dist["std"] + _mirror_variants(mirr_dist["std"], self.mirror_action)[0].abs()) / 2,
        }
        aux = {f"original.backbone.{k}": v for k, v in orig_aux.items()}
        aux["original.backbone.output"] = orig_latent
        aux["original.action_dist"] = orig_dist
        aux.update({f"mirrored.backbone.{k}": v for k, v in mirr_aux.items()})
        aux["mirrored.backbone.output"] = mirr_latent
        aux["mirrored.action_dist"] = mirr_dist
        aux["backbone.output"] = orig_latent
        return dist_params, new_memory, aux

    def act_deterministic(self, observation: torch.Tensor, memory=None, **kwargs):
        (orig_latent, _, _), (mirr_latent, _, _), new_memory = self._passes(observation, memory, **kwargs)
        original_action = self.distribution.determine(orig_latent)
        mirrored_action = _mirror_variants(self.distribution.determine(mirr_latent), self.mirror_action)[0]
        return (original_action + mirrored_action) / 2, new_memory
