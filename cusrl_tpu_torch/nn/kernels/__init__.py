"""The kernels, as the JAX package's ``cusrl_tpu.nn.kernels`` exports them."""

from cusrl_tpu_torch.nn.kernels.banded_attention import banded_window_attention

__all__ = ["banded_window_attention"]
