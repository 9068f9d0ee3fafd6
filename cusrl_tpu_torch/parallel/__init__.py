from cusrl_tpu_torch.parallel.multiprocess import broadcast_agent_state, cross_process_update, globalize_rollout
from cusrl_tpu_torch.parallel.sharding import data_axes, distribute_agent, get_mesh, replicate, shard_batch

__all__ = [
    "broadcast_agent_state",
    "cross_process_update",
    "data_axes",
    "distribute_agent",
    "get_mesh",
    "globalize_rollout",
    "replicate",
    "shard_batch",
]
