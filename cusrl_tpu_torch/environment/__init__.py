"""The environments, as the JAX package's ``cusrl_tpu.environment`` exports
them.  The IsaacLab and mjlab adapters stay out: neither simulator is
installed where the port runs."""

from cusrl_tpu_torch.environment.gym import GymEnvAdapter, GymVectorEnvAdapter, make_gym_env, make_gym_vec
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.environment.native import NativeCartPoleEnv, build_native_library
