"""The framework's templates, as the JAX package's ``cusrl_tpu.template``
exports them, resolved at first use.  JAX's ``JaxEnvironment``,
``ScanRolloutDriver`` and ``AgentState`` have PyTorch counterparts of other
names: ``TensorEnvironment`` and ``RolloutDriver`` (an agent's state lives in
its modules and hooks)."""

from cusrl_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "actor_critic": ("ActorCritic", "ActorCriticFactory"),
    "agent": ("Agent", "AgentFactory"),
    "buffer": ("Buffer", "Sampler"),
    "environment": ("Environment", "EnvironmentSpec", "TensorEnvironment", "get_done_indices",
                    "update_observation_and_state"),
    "hook": ("Hook", "HookComposite"),
    "logger": ("Logger", "LoggerFactory", "make_logger_factory"),
    "optimizer": ("AdamFactory", "AdamWFactory", "Optimizer", "OptimizerFactory", "SgdFactory", "build_optimizer"),
    "player": ("Player", "PlayerHook"),
    "rollout": ("RolloutDriver",),
    "trainer": ("EnvironmentStats", "Trainer", "TrainerHook"),
    "trial": ("Trial",),
})
