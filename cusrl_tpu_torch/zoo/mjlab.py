"""mjlab experiments (counterpart of ``cusrl_tpu/zoo/mjlab.py``): the velocity
and tracking tasks, their kwargs the JAX entries' letter for letter, played
through ``MjlabPlayer``.  The entries register without mjlab;
``make_mjlab_env`` raises ``ImportError`` where an environment is built
without it.
"""

from cusrl_tpu_torch.environment.mjlab import MjlabPlayer, make_mjlab_env
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.zoo.registry import register_experiment

__all__ = []

_VELOCITY_AGENT_KWARGS = dict(
    num_steps_per_update=24,
    actor_hidden_dims=(512, 256, 128),
    critic_hidden_dims=(512, 256, 128),
    activation_fn="elu",
    lr=1e-3,
    sampler_epochs=5,
    sampler_mini_batches=4,
    orthogonal_init=False,
    normalize_observation=True,
    value_loss_weight=1.0,
    value_loss_clip=0.2,
    grad_clip_groups={"actor": 1.0, "critic": 1.0},
    desired_kl_divergence=0.015,
)

for _task in (
    "Mjlab-Velocity-Flat-Unitree-G1",
    "Mjlab-Velocity-Flat-Unitree-Go1",
    "Mjlab-Velocity-Rough-Unitree-G1",
    "Mjlab-Velocity-Rough-Unitree-Go1",
):
    register_experiment(
        environment_name=_task,
        algorithm_name="ppo",
        agent_meta_factory=PpoAgentFactory,
        agent_meta_factory_kwargs=dict(_VELOCITY_AGENT_KWARGS, entropy_loss_weight=0.01),
        training_env_factory=make_mjlab_env,
        training_env_factory_kwargs={"id": _task},
        playing_env_factory=make_mjlab_env,
        playing_env_factory_kwargs={"id": _task, "play": True},
        player_factory=MjlabPlayer,
        num_iterations=20000,
        checkpoint_interval=500,
    )

for _task in (
    "Mjlab-Tracking-Flat-Unitree-G1",
    "Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation",
):
    register_experiment(
        environment_name=_task,
        algorithm_name="ppo",
        agent_meta_factory=PpoAgentFactory,
        agent_meta_factory_kwargs=dict(_VELOCITY_AGENT_KWARGS, entropy_loss_weight=0.005),
        training_env_factory=make_mjlab_env,
        training_env_factory_kwargs={"id": _task},
        playing_env_factory=make_mjlab_env,
        playing_env_factory_kwargs={"id": _task, "play": True},
        player_factory=MjlabPlayer,
        num_iterations=30000,
        checkpoint_interval=500,
    )
