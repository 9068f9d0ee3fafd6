"""Layers and modules, as the JAX package's ``cusrl_tpu.nn`` exports them
(those the port has)."""

from cusrl_tpu_torch.nn.base import Memory, reset_memory, storable_memory
from cusrl_tpu_torch.nn.layer.bijector import (
    Bijector,
    ExponentialBijector,
    IdentityBijector,
    SigmoidBijector,
    SoftplusBijector,
    make_bijector,
)
from cusrl_tpu_torch.nn.layer.encoding import RotaryEmbedding, alibi_slopes
from cusrl_tpu_torch.nn.layer.gate import GruGate, HighwayGate, InputGate, OutputGate, ResidualGate, make_gate
from cusrl_tpu_torch.nn.layer.linear import Linear, get_activation
from cusrl_tpu_torch.nn.layer.loss import GradientPenaltyLoss, L2RegularizationLoss, NormalNllLoss, gradient_penalty
from cusrl_tpu_torch.nn.layer.mha import FeedForward, MultiheadAttention, scaled_dot_product_attention
from cusrl_tpu_torch.nn.layer.rms import RunningMeanStd
from cusrl_tpu_torch.nn.module.actor import Actor, ActorFactory
from cusrl_tpu_torch.nn.module.causal_attn import (
    CausalMultiheadSelfAttention,
    CausalTransformerEncoderLayer,
    CausalTransformerEncoderLayerFactory,
)
from cusrl_tpu_torch.nn.module.critic import Value, ValueFactory
from cusrl_tpu_torch.nn.module.distribution import (
    AdaptiveNormalDist,
    AdaptiveNormalDistFactory,
    NormalDist,
    NormalDistFactory,
    OneHotCategoricalDist,
    OneHotCategoricalDistFactory,
)
from cusrl_tpu_torch.nn.module.mlp import Mlp, MlpFactory
from cusrl_tpu_torch.nn.module.rnn import Gru, Lstm, RnnFactory, VanillaRnn
from cusrl_tpu_torch.nn.module.sequential import Sequential, SequentialFactory
from cusrl_tpu_torch.nn.module.stub import Identity, IdentityFactory, StubModule, StubModuleFactory
