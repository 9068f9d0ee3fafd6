"""Box2D experiments (counterpart of ``cusrl_tpu/zoo/gym/box2d.py``; their
kwargs are the JAX entries' letter for letter).  Box2D needs gymnasium's
optional ``box2d`` extra: the entries register regardless and fail where
their environment is built."""

from cusrl_tpu_torch.environment.gym import make_gym_env, make_gym_vec
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.zoo.registry import register_experiment

register_experiment(
    environment_name="BipedalWalker-v3",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=2048,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        lr=3e-4,
        sampler_epochs=4,
        sampler_mini_batches=16,
        orthogonal_init=False,
        normalize_observation=True,
        gae_gamma=0.999,
        gae_lamda=0.95,
        entropy_loss_weight=0.0,
        max_grad_norm=0.5,
        desired_kl_divergence=0.01,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "BipedalWalker-v3", "num_envs": 16},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "BipedalWalker-v3", "render_mode": "human"},
    num_iterations=400,
    checkpoint_interval=50,
)

register_experiment(
    environment_name="LunarLanderContinuous-v3",
    algorithm_name="ppo",
    agent_meta_factory=PpoAgentFactory,
    agent_meta_factory_kwargs=dict(
        num_steps_per_update=1024,
        actor_hidden_dims=(64, 64),
        critic_hidden_dims=(64, 64),
        activation_fn="tanh",
        lr=3e-4,
        sampler_epochs=4,
        sampler_mini_batches=16,
        normalize_observation=True,
        entropy_loss_weight=0.001,
    ),
    training_env_factory=make_gym_vec,
    training_env_factory_kwargs={"id": "LunarLanderContinuous-v3", "num_envs": 8},
    playing_env_factory=make_gym_env,
    playing_env_factory_kwargs={"id": "LunarLanderContinuous-v3", "render_mode": "human"},
    num_iterations=300,
    checkpoint_interval=50,
)
