"""robot_lab experiments (counterpart of ``cusrl_tpu/zoo/robot_lab.py``):
IsaacLab tasks of the robot_lab extension (imported as ``robot_lab.tasks`` by
the launcher), their kwargs the JAX entries' letter for letter.
"""

from cusrl_tpu_torch.environment.isaaclab import make_isaaclab_env
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.zoo.registry import register_experiment

__all__ = []

for _task in (
    "RobotLab-Isaac-Velocity-Rough-Anymal-D-v0",
    "RobotLab-Isaac-Velocity-Rough-Unitree-A1-v0",
    "RobotLab-Isaac-Velocity-Rough-HandStand-Unitree-A1-v0",
    "RobotLab-Isaac-Velocity-Rough-Unitree-B2-v0",
    "RobotLab-Isaac-Velocity-Rough-Unitree-Go2-v0",
):
    register_experiment(
        environment_name=_task,
        algorithm_name="ppo",
        agent_meta_factory=PpoAgentFactory,
        agent_meta_factory_kwargs=dict(
            num_steps_per_update=24,
            actor_hidden_dims=(512, 256, 128),
            critic_hidden_dims=(512, 256, 128),
            activation_fn="elu",
            lr=1e-3,
            sampler_epochs=5,
            sampler_mini_batches=4,
            orthogonal_init=False,
            entropy_loss_weight=0.01,
            desired_kl_divergence=0.015,
        ),
        training_env_factory=make_isaaclab_env,
        training_env_factory_kwargs={"task": _task, "extensions": ["robot_lab"]},
        playing_env_factory=make_isaaclab_env,
        playing_env_factory_kwargs={"task": _task, "extensions": ["robot_lab"], "play": True},
        num_iterations=20000,
        checkpoint_interval=500,
    )
