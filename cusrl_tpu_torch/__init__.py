"""PyTorch/CUDA port of ``cusrl_tpu``.

Same sub-package layout and module names as the JAX package, so every module
here has one counterpart there, and the same top-level names (less the
JAX-only ``Module``, ``JaxEnvironment`` and ``ScanRolloutDriver``; the port's
``TensorEnvironment`` and ``RolloutDriver`` stand in their place), resolved at
first use.  The port imports ``torch`` and numpy only; its hand-written Hopper
kernels live in ``csrc/`` and build with ``nvcc`` at first use
(``nn/kernels/build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise instead of falling back.
"""

from cusrl_tpu_torch._exports import lazy_exports

__version__ = "0.1.0"

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "export": ("ExportedStatefulPolicy", "InferencePolicy", "InferenceWrapper", "export_agent", "load_exported_graph",
               "load_exported_policy"),
    "nn": ("Actor", "ActorFactory", "AdaptiveNormalDist", "Mlp", "MlpFactory", "NormalDist", "OneHotCategoricalDist",
           "RunningMeanStd", "Value", "ValueFactory"),
    "preset": ("PpoAgentFactory", "RecurrentPpoAgentFactory", "TransformerPpoAgentFactory", "ppo_hook_suite"),
    "sampler": ("AutoMiniBatchSampler", "MiniBatchSampler", "TemporalMiniBatchSampler"),
    "template": ("ActorCritic", "ActorCriticFactory", "Agent", "AgentFactory", "Buffer", "Environment",
                 "EnvironmentSpec", "Hook", "Logger", "LoggerFactory", "Player", "RolloutDriver", "TensorEnvironment",
                 "Trainer", "Trial", "make_logger_factory"),
    "utils": ("CONFIG", "Metrics", "Rate", "Timer", "set_global_seed"),
}, ("environment", "hook", "nn", "preset", "sampler", "template", "testing", "utils"))
