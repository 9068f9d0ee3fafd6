"""Velocity-command locomotion benchmark environment on device tensors
(counterpart of ``cusrl_tpu/environment/locomotion.py``).

Each of N instances tracks a random planar velocity command with a 12-D action
mapped through a fixed actuation matrix, observes a 48-D feature vector,
terminates when it leaves the arena and truncates on a time limit.  The fixed
``actuation`` ``[2, A]`` and ``obs_proj`` ``[8 + A, obs]`` matrices are drawn
from a torch generator seeded with ``seed``, or taken as given (so a test can
hand in the JAX environment's matrices).  ``demonstration_dataset`` rolls a
scripted controller out on it for AMP's expert transitions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cusrl_tpu_torch.template.environment import EnvironmentSpec, TensorEnvironment
from cusrl_tpu_torch.utils.config import resolve_device

__all__ = ["VelocityLocomotionEnv", "demonstration_dataset"]


class VelocityLocomotionEnv(TensorEnvironment):
    def __init__(
        self,
        num_instances: int = 4096,
        observation_dim: int = 48,
        action_dim: int = 12,
        episode_length: int = 1000,
        dt: float = 0.02,
        arena_half_size: float = 50.0,
        seed: int = 0,
        device: str | torch.device | None = None,
        actuation: np.ndarray | torch.Tensor | None = None,
        obs_proj: np.ndarray | torch.Tensor | None = None,
    ):
        spec = EnvironmentSpec(
            observation_dim=observation_dim,
            action_dim=action_dim,
            num_instances=num_instances,
            reward_dim=1,
            timestep=dt,
        )
        super().__init__(spec)
        self.device = resolve_device(device)
        self.episode_length = episode_length
        self.dt = dt
        self.arena_half_size = arena_half_size
        raw_dim = 8 + action_dim  # pos(2) vel(2) cmd(2) phase(2) last_action(A)
        generator = torch.Generator().manual_seed(seed)
        if actuation is None:
            actuation = torch.randn(2, action_dim, generator=generator) / math.sqrt(action_dim)
        if obs_proj is None:
            obs_proj = torch.randn(raw_dim, observation_dim, generator=generator) / math.sqrt(raw_dim)
        self._actuation = torch.tensor(np.asarray(actuation), dtype=torch.float32).to(self.device)
        self._obs_proj = torch.tensor(np.asarray(obs_proj), dtype=torch.float32).to(self.device)
        if self._actuation.shape != (2, action_dim) or self._obs_proj.shape != (raw_dim, observation_dim):
            raise ValueError("actuation must be [2, action_dim] and obs_proj [8 + action_dim, observation_dim]")

    def _sample_command(self, generator, n):
        return torch.rand(n, 2, generator=generator, device=self.device) * 2.0 - 1.0

    def init_fn(self, generator):
        n, dev = self.num_instances, self.device
        return {
            "pos": torch.zeros(n, 2, device=dev),
            "vel": torch.zeros(n, 2, device=dev),
            "command": self._sample_command(generator, n),
            "last_action": torch.zeros(n, self.spec.action_dim, device=dev),
            "steps": torch.zeros(n, dtype=torch.int32, device=dev),
        }

    def observe_fn(self, env_state):
        phase = env_state["steps"].float() * (2.0 * math.pi / 50.0)
        raw = torch.cat(
            [
                env_state["pos"] / self.arena_half_size,
                env_state["vel"],
                env_state["command"],
                torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1),
                env_state["last_action"],
            ],
            dim=-1,
        )
        return torch.tanh(raw @ self._obs_proj), None

    def step_fn(self, env_state, action, generator):
        action = torch.clamp(action.float(), -1.0, 1.0)
        accel = action @ self._actuation.T
        vel = env_state["vel"] * 0.98 + self.dt * accel * 10.0
        pos = env_state["pos"] + self.dt * vel
        steps = env_state["steps"] + 1
        tracking_error = torch.sum((vel - env_state["command"]).square(), dim=-1)
        action_penalty = 0.01 * torch.sum(action.square(), dim=-1)
        reward = (torch.exp(-tracking_error) - action_penalty)[:, None]
        terminated = (torch.amax(pos.abs(), dim=-1) > self.arena_half_size)[:, None]
        truncated = (steps >= self.episode_length)[:, None]
        reset = terminated | truncated
        new_command = self._sample_command(generator, self.num_instances)
        new_state = {
            "pos": torch.where(reset, 0.0, pos),
            "vel": torch.where(reset, 0.0, vel),
            "command": torch.where(reset, new_command, env_state["command"]),
            "last_action": torch.where(reset, 0.0, action),
            "steps": torch.where(reset[:, 0], 0, steps).to(torch.int32),
        }
        return new_state, reward, terminated, truncated, {}


@torch.no_grad()
def demonstration_dataset(
    num_transitions: int = 65536,
    state_indices: tuple[int, ...] = tuple(range(16)),
    num_instances: int = 256,
    seed: int = 1,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
    env: VelocityLocomotionEnv | None = None,
    init_state: dict | None = None,
) -> torch.Tensor:
    """``[num_transitions, 2 * len(state_indices)]`` expert ``(obs_t,
    obs_{t+1})`` pairs on ``state_indices`` for the AMP discriminator: a
    scripted velocity-tracking controller (the least-squares inverse of the
    actuation matrix, ``pinv(actuation.T)``) rolled out on
    ``VelocityLocomotionEnv(num_instances, seed=seed)`` on ``device`` (None:
    the card), rows ordered step by step.  ``generator`` draws the commands
    (a generator on ``device`` seeded with ``seed + 1`` when None); ``env``
    and ``init_state`` replace the environment and its first state (a test
    hands in the JAX environment's matrices and state)."""
    if env is None:
        env = VelocityLocomotionEnv(num_instances=num_instances, seed=seed, device=device)
    device = env.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed + 1)
    steps = -(-num_transitions // env.num_instances)
    inverse_actuation = torch.linalg.pinv(env._actuation.T)  # [2, A]
    idx = torch.tensor(state_indices, dtype=torch.long, device=device)
    state = env.init_fn(generator) if init_state is None else init_state
    pairs = []
    obs, _ = env.observe_fn(state)
    for _ in range(steps):
        desired_accel = (state["command"] - state["vel"]) * (5.0 / (env.dt * 10.0))
        action = torch.clamp(desired_accel @ inverse_actuation, -1.0, 1.0)
        state, _, _, _, _ = env.step_fn(state, action, generator)
        next_obs, _ = env.observe_fn(state)
        pairs.append(torch.cat([obs[..., idx], next_obs[..., idx]], dim=-1))
        obs = next_obs
    return torch.cat(pairs)[:num_transitions]
