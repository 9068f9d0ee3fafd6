"""The utilities, as the JAX package's ``cusrl_tpu.utils`` exports them,
resolved at first use.  JAX's ``mesh``, ``device_count`` and ``new_key`` have
no counterpart: the port's process topology is ``torch.distributed``'s
(``configure_distributed``) and its draws come from ``torch.Generator``s."""

from cusrl_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "config": ("CONFIG", "configure_distributed"),
    "dict_utils": ("from_dict", "get_first", "prefix_dict_keys", "to_dict"),
    "metrics": ("Metrics",),
    "misc": ("MISSING", "import_module", "import_obj", "set_global_seed", "to_numpy"),
    "scheduler": ("CosineAnnealingScheduler", "ExponentialScheduler", "LessThan", "NotLessThan",
                  "PiecewiseLinearScheduler", "StepScheduler", "TanhScheduler"),
    "timing": ("Rate", "Timer", "sync"),
}, ("distributed", "nest"))
