"""The hooks, as the JAX package's ``cusrl_tpu.hook`` exports them (those
the port has)."""

from cusrl_tpu_torch.hook.auxiliary.amp import AdversarialMotionPrior
from cusrl_tpu_torch.hook.auxiliary.distillation import PolicyDistillation, PolicyDistillationLoss
from cusrl_tpu_torch.hook.auxiliary.estimation import StateEstimation
from cusrl_tpu_torch.hook.auxiliary.representation import NextStatePrediction, ReturnPrediction, StatePrediction
from cusrl_tpu_torch.hook.auxiliary.rnd import RandomNetworkDistillation
from cusrl_tpu_torch.hook.auxiliary.smoothness import ActionSmoothnessLoss
from cusrl_tpu_torch.hook.auxiliary.symmetry import (
    MirrorDef,
    MirrorSymmetryLoss,
    SymmetricActor,
    SymmetricArchitecture,
    SymmetricDataAugmentation,
    TransitionMirroring,
)
from cusrl_tpu_torch.hook.control.condition import ConditionalObjectiveActivation, EpochIndexCondition
from cusrl_tpu_torch.hook.control.initialization import ModuleInitialization
from cusrl_tpu_torch.hook.control.memory import DeviceMemoryStats, EmptyCudaCache
from cusrl_tpu_torch.hook.control.optimization_stage import OptimizationStage
from cusrl_tpu_torch.hook.control.schedule import HookActivationSchedule, HookParameterSchedule
from cusrl_tpu_torch.hook.mdp.environment_spec import DynamicEnvironmentSpecOverride, EnvironmentSpecOverride
from cusrl_tpu_torch.hook.mdp.observation import ObservationNanToNum, ObservationNormalization
from cusrl_tpu_torch.hook.mdp.reward import RewardShaping
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageNormalization, AdvantageReduction
from cusrl_tpu_torch.hook.on_policy.buffer_schedule import OnPolicyBufferCapacitySchedule
from cusrl_tpu_torch.hook.on_policy.common import OnPolicyPreparation
from cusrl_tpu_torch.hook.on_policy.gae import GeneralizedAdvantageEstimation
from cusrl_tpu_torch.hook.on_policy.gradient_clipping import GradientClipping
from cusrl_tpu_torch.hook.on_policy.joint_eval import JointPolicyValueEvaluation
from cusrl_tpu_torch.hook.on_policy.lr_schedule import (
    AdaptiveLRSchedule,
    MiniBatchWiseLRSchedule,
    ThresholdLRSchedule,
)
from cusrl_tpu_torch.hook.on_policy.ppo import EntropyLoss, PpoSurrogateLoss
from cusrl_tpu_torch.hook.on_policy.stats import OnPolicyStatistics
from cusrl_tpu_torch.hook.on_policy.value import ValueComputation, ValueLoss
from cusrl_tpu_torch.hook.player.save_transition import SaveTransition
