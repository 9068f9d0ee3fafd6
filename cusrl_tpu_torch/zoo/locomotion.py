"""Velocity-locomotion experiments (counterpart of the ``ppo``,
``recurrent_ppo``, ``transformer_ppo`` and ``amp`` entries of
``cusrl_tpu/zoo/locomotion.py``; their kwargs are the JAX entries' letter for
letter).
"""

from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv, demonstration_dataset
from cusrl_tpu_torch.preset.amp import AmpAgentFactory
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory, RecurrentPpoAgentFactory, TransformerPpoAgentFactory
from cusrl_tpu_torch.zoo.registry import register_experiment

register_experiment(
    environment_name="Velocity-Flat",
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
        normalize_observation=True,
        desired_kl_divergence=0.015,
        entropy_loss_weight=0.005,
        fuse_actor_critic_evaluation=True,
    ),
    training_env_factory=VelocityLocomotionEnv,
    training_env_factory_kwargs={"num_instances": 4096},
    benchmarking_env_factory=VelocityLocomotionEnv,
    benchmarking_env_factory_kwargs={"num_instances": 64},
    num_iterations=300,
    checkpoint_interval=50,
    iterations_per_dispatch=10,
)

register_experiment(
    environment_name="Velocity-Rough",
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
        normalize_observation=True,
        desired_kl_divergence=0.01,
        entropy_loss_weight=0.005,
        fuse_actor_critic_evaluation=True,
    ),
    training_env_factory=VelocityLocomotionEnv,
    training_env_factory_kwargs={"num_instances": 4096},
    benchmarking_env_factory=VelocityLocomotionEnv,
    benchmarking_env_factory_kwargs={"num_instances": 64},
    num_iterations=1500,
    checkpoint_interval=200,
    iterations_per_dispatch=10,
)

register_experiment(
    environment_name="Velocity-Flat",
    algorithm_name="recurrent_ppo",
    agent_meta_factory=RecurrentPpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=24,
        rnn_type="gru",
        rnn_hidden_size=256,
        mlp_hidden_dims=(128,),
        activation_fn="elu",
        lr=1e-3,
        sampler_epochs=5,
        sampler_mini_batches=4,
        normalize_observation=True,
        desired_kl_divergence=0.015,
    ),
    training_env_factory=VelocityLocomotionEnv,
    training_env_factory_kwargs={"num_instances": 1024},
    benchmarking_env_factory=VelocityLocomotionEnv,
    benchmarking_env_factory_kwargs={"num_instances": 64},
    num_iterations=300,
    checkpoint_interval=50,
    iterations_per_dispatch=10,
)

# The windowed causal-attention policy on the same task.
register_experiment(
    environment_name="Velocity-Flat",
    algorithm_name="transformer_ppo",
    agent_meta_factory=TransformerPpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=24,
        embed_dim=128,
        num_heads=4,
        attention_window=16,
        mlp_hidden_dims=(128,),
        activation_fn="elu",
        lr=1e-3,
        sampler_epochs=5,
        sampler_mini_batches=4,
        normalize_observation=True,
        desired_kl_divergence=0.015,
    ),
    training_env_factory=VelocityLocomotionEnv,
    training_env_factory_kwargs={"num_instances": 1024},
    benchmarking_env_factory=VelocityLocomotionEnv,
    benchmarking_env_factory_kwargs={"num_instances": 64},
    num_iterations=300,
    checkpoint_interval=50,
    iterations_per_dispatch=10,
)

# On-device AMP: style reward from a discriminator against scripted
# velocity-tracking demonstrations.
register_experiment(
    environment_name="Velocity-Flat",
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
        init_distribution_std=0.1,
        extrinsic_reward_scale=0.1,
        amp_discriminator_hidden_dims=(512, 256),
        amp_state_indices=tuple(range(16)),
        amp_dataset_source=demonstration_dataset,
        entropy_loss_weight=0.005,
    ),
    training_env_factory=VelocityLocomotionEnv,
    training_env_factory_kwargs={"num_instances": 1024},
    benchmarking_env_factory=VelocityLocomotionEnv,
    benchmarking_env_factory_kwargs={"num_instances": 64},
    num_iterations=3000,
    checkpoint_interval=500,
)
