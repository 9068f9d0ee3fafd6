"""Layers and modules, as the JAX package's ``cusrl_tpu.nn`` exports them.
JAX's ``Module``, ``ModuleFactory`` and pytree helpers (``partition``,
``combine``, ``static_field``, ...) have no counterpart: the port's modules are
``torch.nn.Module``s."""

from cusrl_tpu_torch.nn.base import Memory, reset_memory, storable_memory
from cusrl_tpu_torch.nn.layer.activation import DetachGradient, GeGlu, ParameterWrapper, SwiGlu
from cusrl_tpu_torch.nn.layer.bijector import (
    Bijector,
    ExponentialBijector,
    IdentityBijector,
    SigmoidBijector,
    SoftplusBijector,
    make_bijector,
)
from cusrl_tpu_torch.nn.layer.encoding import (
    LearnablePositionalEncoding,
    RotaryEmbedding,
    SinusoidalPositionalEncoding,
    alibi_slopes,
)
from cusrl_tpu_torch.nn.layer.gate import GruGate, HighwayGate, InputGate, OutputGate, ResidualGate, make_gate
from cusrl_tpu_torch.nn.layer.linear import ACTIVATIONS, Linear, get_activation
from cusrl_tpu_torch.nn.layer.loss import GradientPenaltyLoss, L2RegularizationLoss, NormalNllLoss, gradient_penalty
from cusrl_tpu_torch.nn.layer.mha import (
    FeedForward,
    MultiheadAttention,
    MultiheadCrossAttention,
    MultiheadSelfAttention,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
    scaled_dot_product_attention,
)
from cusrl_tpu_torch.nn.layer.rms import RunningMeanStd
from cusrl_tpu_torch.nn.module.actor import Actor, ActorFactory
from cusrl_tpu_torch.nn.module.causal_attn import (
    CausalMultiheadSelfAttention,
    CausalTransformerEncoderLayer,
    CausalTransformerEncoderLayerFactory,
)
from cusrl_tpu_torch.nn.module.cnn import Cnn, CnnFactory
from cusrl_tpu_torch.nn.module.critic import Value, ValueFactory
from cusrl_tpu_torch.nn.module.distribution import (
    AdaptiveNormalDist,
    AdaptiveNormalDistFactory,
    Distribution,
    NormalDist,
    NormalDistFactory,
    OneHotCategoricalDist,
    OneHotCategoricalDistFactory,
)
from cusrl_tpu_torch.nn.module.mlp import Mlp, MlpFactory
from cusrl_tpu_torch.nn.module.rnn import Gru, Lstm, Rnn, RnnFactory, VanillaRnn
from cusrl_tpu_torch.nn.module.sequential import Sequential, SequentialFactory
from cusrl_tpu_torch.nn.module.simba import Simba, SimbaFactory
from cusrl_tpu_torch.nn.module.stub import Identity, IdentityFactory, StubModule, StubModuleFactory
