"""Classic-control experiments (counterpart of
``cusrl_tpu/zoo/gym/classic_control.py``; their kwargs are the JAX entries'
letter for letter).  Every entry registers without gymnasium and fails only
where its environment is built."""

from cusrl_tpu_torch.environment.gym import make_gym_env, make_gym_vec
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.zoo.registry import register_experiment

register_experiment(
    environment_name="CartPole-v1",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=32,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        action_space_type="discrete",
        lr=1e-3,
        sampler_epochs=20,
        sampler_mini_batches=1,
        gae_gamma=0.8,
        gae_lamda=0.98,
        entropy_loss_weight=0.0,
        max_grad_norm=0.5,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "CartPole-v1", "num_envs": 8},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "CartPole-v1", "render_mode": "human"},
    num_iterations=400,
    checkpoint_interval=50,
)

register_experiment(
    environment_name="MountainCar-v0",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=16,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        action_space_type="discrete",
        lr=3e-4,
        sampler_epochs=4,
        sampler_mini_batches=4,
        orthogonal_init=False,
        normalize_observation=True,
        gae_gamma=0.99,
        gae_lamda=0.98,
        entropy_loss_weight=0.0,
        max_grad_norm=0.5,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "MountainCar-v0", "num_envs": 16},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "MountainCar-v0", "render_mode": "human"},
    num_iterations=2000,
    checkpoint_interval=500,
)

register_experiment(
    environment_name="MountainCarContinuous-v0",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=8,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        value_loss_weight=0.19,
        lr=7.77e-5,
        sampler_epochs=10,
        sampler_mini_batches=1,
        orthogonal_init=False,
        init_distribution_std=0.04,
        normalize_observation=True,
        gae_gamma=0.9999,
        gae_lamda=0.9,
        surrogate_clip_ratio=0.1,
        entropy_loss_weight=0.00429,
        max_grad_norm=5.0,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "MountainCarContinuous-v0", "num_envs": 4},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "MountainCarContinuous-v0", "render_mode": "human"},
    num_iterations=50,
    checkpoint_interval=10,
)

register_experiment(
    environment_name="Pendulum-v1",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=1024,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        lr=1e-3,
        sampler_epochs=10,
        sampler_mini_batches=64,
        normalize_observation=True,
        gae_gamma=0.9,
        gae_lamda=0.95,
        entropy_loss_weight=0.0,
        max_grad_norm=0.5,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "Pendulum-v1", "num_envs": 4},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "Pendulum-v1", "render_mode": "human"},
    num_iterations=50,
    checkpoint_interval=10,
)

register_experiment(
    environment_name="Acrobot-v1",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=64,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        action_space_type="discrete",
        lr=3e-4,
        sampler_epochs=4,
        sampler_mini_batches=4,
        normalize_observation=True,
        entropy_loss_weight=0.0,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "Acrobot-v1", "num_envs": 8},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "Acrobot-v1", "render_mode": "human"},
    num_iterations=300,
    checkpoint_interval=50,
)
