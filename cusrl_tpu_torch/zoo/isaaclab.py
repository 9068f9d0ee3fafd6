"""IsaacLab experiments (counterpart of ``cusrl_tpu/zoo/isaaclab.py``): the
classic, velocity-locomotion and humanoid AMP tasks, their kwargs the JAX
entries' letter for letter.  The entries register without IsaacLab;
``make_isaaclab_env`` raises ``ImportError`` where an environment is built
without it.
"""

from cusrl_tpu_torch.environment.isaaclab import make_isaaclab_env
from cusrl_tpu_torch.preset.amp import AmpAgentFactory
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.zoo.registry import register_experiment

__all__ = []

# --- classic (cusrl/zoo/isaaclab/classic.py) ------------------------------

for _task, _cfg in {
    "Isaac-Ant-v0": dict(
        num_steps_per_update=32,
        actor_hidden_dims=(512, 256, 128),
        critic_hidden_dims=(512, 256, 128),
        entropy_loss_weight=0.0,
        num_iterations=1000,
    ),
    "Isaac-Cartpole-v0": dict(
        num_steps_per_update=16,
        actor_hidden_dims=(32, 32),
        critic_hidden_dims=(32, 32),
        entropy_loss_weight=0.005,
        num_iterations=150,
        checkpoint_interval=50,
    ),
    "Isaac-Humanoid-v0": dict(
        num_steps_per_update=32,
        actor_hidden_dims=(512, 256, 128),
        critic_hidden_dims=(512, 256, 128),
        entropy_loss_weight=0.0,
        num_iterations=1000,
        normalize_observation=True,
        desired_kl_divergence=0.012,
        checkpoint_interval=200,
    ),
}.items():
    register_experiment(
        environment_name=_task,
        algorithm_name="ppo",
        agent_meta_factory=PpoAgentFactory,
        agent_meta_factory_kwargs=dict(
            num_steps_per_update=_cfg["num_steps_per_update"],
            actor_hidden_dims=_cfg["actor_hidden_dims"],
            critic_hidden_dims=_cfg["critic_hidden_dims"],
            activation_fn="elu",
            lr=1e-3,
            sampler_epochs=5,
            sampler_mini_batches=4,
            orthogonal_init=False,
            normalize_observation=_cfg.get("normalize_observation", False),
            entropy_loss_weight=_cfg["entropy_loss_weight"],
            desired_kl_divergence=_cfg.get("desired_kl_divergence", 0.015),
        ),
        training_env_factory=make_isaaclab_env,
        training_env_factory_kwargs={"task": _task},
        playing_env_factory=make_isaaclab_env,
        playing_env_factory_kwargs={"task": _task, "play": True},
        num_iterations=_cfg["num_iterations"],
        checkpoint_interval=_cfg.get("checkpoint_interval", 100),
    )

# --- velocity locomotion (cusrl/zoo/isaaclab/locomotion.py) ----------------

for _task in (
    "Isaac-Velocity-Flat-Anymal-B-v0",
    "Isaac-Velocity-Flat-Anymal-C-v0",
    "Isaac-Velocity-Flat-Anymal-D-v0",
    "Isaac-Velocity-Flat-Unitree-A1-v0",
    "Isaac-Velocity-Flat-Unitree-Go1-v0",
    "Isaac-Velocity-Flat-Unitree-Go2-v0",
    "Isaac-Velocity-Flat-Spot-v0",
):
    register_experiment(
        environment_name=_task,
        algorithm_name="ppo",
        agent_meta_factory=PpoAgentFactory,
        agent_meta_factory_kwargs=dict(
            num_steps_per_update=24,
            actor_hidden_dims=(128, 128, 128),
            critic_hidden_dims=(128, 128, 128),
            activation_fn="elu",
            lr=1e-3,
            sampler_epochs=5,
            sampler_mini_batches=4,
            orthogonal_init=False,
            entropy_loss_weight=0.005,
            desired_kl_divergence=0.015,
        ),
        training_env_factory=make_isaaclab_env,
        training_env_factory_kwargs={"task": _task},
        playing_env_factory=make_isaaclab_env,
        playing_env_factory_kwargs={"task": _task, "play": True},
        num_iterations=300,
        checkpoint_interval=100,
    )

for _task in (
    "Isaac-Velocity-Rough-Anymal-B-v0",
    "Isaac-Velocity-Rough-Anymal-C-v0",
    "Isaac-Velocity-Rough-Anymal-D-v0",
    "Isaac-Velocity-Rough-Unitree-A1-v0",
    "Isaac-Velocity-Rough-Unitree-Go1-v0",
    "Isaac-Velocity-Rough-Unitree-Go2-v0",
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
            entropy_loss_weight=0.005,
            desired_kl_divergence=0.015,
        ),
        training_env_factory=make_isaaclab_env,
        training_env_factory_kwargs={"task": _task},
        playing_env_factory=make_isaaclab_env,
        playing_env_factory_kwargs={"task": _task, "play": True},
        num_iterations=1500,
        checkpoint_interval=100,
    )

# --- humanoid AMP (cusrl/zoo/isaaclab/humanoid_amp.py) ---------------------

for _task in (
    "Isaac-Humanoid-AMP-Dance-Direct-v0",
    "Isaac-Humanoid-AMP-Run-Direct-v0",
    "Isaac-Humanoid-AMP-Walk-Direct-v0",
):
    register_experiment(
        environment_name=_task,
        algorithm_name="amp",
        agent_meta_factory=AmpAgentFactory,
        agent_meta_factory_kwargs=dict(
            num_steps_per_update=16,
            actor_hidden_dims=(512, 256),
            critic_hidden_dims=(512, 256),
            normalize_observation=True,
            activation_fn="relu",
            lr=5e-5,
            sampler_epochs=4,
            sampler_mini_batches=4,
            orthogonal_init=False,
            init_distribution_std=0.1,
            extrinsic_reward_scale=0.0,
            amp_discriminator_hidden_dims=(512, 256),
            entropy_loss_weight=0.005,
        ),
        training_env_factory=make_isaaclab_env,
        training_env_factory_kwargs={"task": _task},
        playing_env_factory=make_isaaclab_env,
        playing_env_factory_kwargs={"task": _task, "play": True},
        num_iterations=3000,
        checkpoint_interval=500,
    )
