"""The environments, as the JAX package's ``cusrl_tpu.environment`` exports
them: the gym adapters, the device-resident locomotion task, the native
CartPole, and the IsaacLab and mjlab adapters, which hand device copies of
the simulator's tensors to the agent (the simulators themselves are
imported only where an environment is built)."""

from cusrl_tpu_torch.environment.gym import GymEnvAdapter, GymVectorEnvAdapter, make_gym_env, make_gym_vec
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.environment.isaaclab import IsaacLabEnvAdapter, IsaacLabEnvLauncher, TrainerCfg, make_isaaclab_env
from cusrl_tpu_torch.environment.mjlab import MjlabEnvAdapter, MjlabPlayer, make_mjlab_env
from cusrl_tpu_torch.environment.native import NativeCartPoleEnv, build_native_library
