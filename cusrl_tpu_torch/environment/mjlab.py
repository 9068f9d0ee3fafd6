"""mjlab (MuJoCo Warp) environment adapter (counterpart of
``cusrl_tpu/environment/mjlab.py``).

mjlab is imported inside the factories only: the adapter and the zoo's
entries load without it, and building an environment or its configuration
without it raises ``ImportError``.  The adapter is IsaacLab's
(``ManagerBasedEnvAdapter``: the observation groups, autoreset, missing final
states, ``extras["log"]`` metrics, the simulator's tensors handed through on
its device) without demonstrations, as in the JAX package.
:class:`MjlabPlayer` is the policy callable mjlab's viewers drive.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from cusrl_tpu_torch.environment.isaaclab import ManagerBasedEnvAdapter
from cusrl_tpu_torch.template.player import Player

__all__ = ["MjlabEnvAdapter", "MjlabPlayer", "make_mjlab_env"]


class MjlabEnvAdapter(ManagerBasedEnvAdapter):
    """An mjlab ``ManagerBasedRlEnv`` as an ``Environment`` (no demonstrations)."""

    demonstrations = False


class MjlabPlayer(Player):
    """A Player that is the policy callable: mjlab's viewers run the loop and
    call it each frame with the observation groups; the action stays on the
    agent's device.  Without ``mjlab.viewer`` the playing loop is the
    Player's own."""

    def __call__(self, observation_dict):
        n = self.environment.num_instances
        observation = torch.as_tensor(observation_dict["policy"]).reshape(n, -1)
        state = None
        if self.environment.spec.state_dim is not None and "critic" in observation_dict:
            state = torch.as_tensor(observation_dict["critic"]).reshape(n, -1)
        return self.agent.act(observation, state)

    def run_playing_loop(self) -> dict[str, float]:
        try:
            from mjlab.viewer import NativeViewer
        except ImportError:
            return super().run_playing_loop()
        NativeViewer(self.environment.wrapped, policy=self).run()
        return self.metrics.summary()


def make_mjlab_env(id: str, config: Any = None, argv: Sequence[str] = (), play: bool = False,
                   **kwargs: Any) -> MjlabEnvAdapter:
    """An mjlab environment of the registered task ``id`` (its configuration
    from ``make_mjlab_env_config`` unless ``config`` is given); ``kwargs``
    (the zoo's ``device`` among them) go to ``ManagerBasedRlEnv``."""
    try:
        from mjlab.env import ManagerBasedRlEnv
    except ImportError as error:
        raise ImportError("make_mjlab_env requires an mjlab installation") from error
    if config is None:
        config = make_mjlab_env_config(id, play=play)
    return MjlabEnvAdapter(ManagerBasedRlEnv(cfg=config, **kwargs))


def make_mjlab_env_config(id: str, play: bool = False) -> Any:
    """The registered task's environment configuration, in a dataclass that
    adds the ``device`` field ``ManagerBasedRlEnv`` expects (and the viewer's
    fields for ``play``)."""
    import dataclasses

    try:
        from mjlab.envs import ManagerBasedRlEnvCfg
        from mjlab.tasks.registry import load_env_cfg
    except ImportError as error:
        raise ImportError("make_mjlab_env_config requires an mjlab installation") from error

    @dataclasses.dataclass
    class ManagerBasedRlEnvCfgWithDevice(ManagerBasedRlEnvCfg):
        device: Any = None

    @dataclasses.dataclass
    class ManagerBasedRlEnvPlayCfg(ManagerBasedRlEnvCfgWithDevice):
        headless: bool = False
        viewer_type: Any = "viser"
        viser_host: str = "0.0.0.0"
        viser_port: int = 8080

    config_class = ManagerBasedRlEnvPlayCfg if play else ManagerBasedRlEnvCfgWithDevice
    env_cfg = load_env_cfg(id, play=play)
    return config_class(**{field.name: getattr(env_cfg, field.name) for field in dataclasses.fields(env_cfg)})
