"""Data and tensor parallelism over process groups, as the JAX package's
``cusrl_tpu.parallel`` exports it, resolved at first use."""

from cusrl_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "multiprocess": ("broadcast_agent_state", "cross_process_update", "globalize_rollout"),
    "sharding": ("ProcessMesh", "collect_tp_specs", "data_axes", "distribute_agent", "get_mesh", "replicate",
                 "shard_batch", "tensor_parallel_rules"),
})
