from cusrl_tpu_torch.preset.amp import AmpAgentFactory
from cusrl_tpu_torch.preset.distillation import DistillationAgentFactory, distillation_hook_suite
from cusrl_tpu_torch.preset.optimizer import AdamFactory, AdamWFactory, SgdFactory
from cusrl_tpu_torch.preset.ppo import (
    PpoAgentFactory,
    RecurrentPpoAgentFactory,
    TransformerPpoAgentFactory,
    ppo_hook_suite,
)
