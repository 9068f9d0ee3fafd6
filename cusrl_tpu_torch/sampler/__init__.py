from cusrl_tpu_torch.sampler.mini_batch_sampler import (
    AutoMiniBatchSampler,
    MiniBatchSampler,
    TemporalMiniBatchSampler,
)
from cusrl_tpu_torch.sampler.random_sampler import AutoRandomSampler, RandomSampler, TemporalRandomSampler
