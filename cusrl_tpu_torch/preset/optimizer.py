"""Optimizer factory presets (counterpart of ``cusrl_tpu/preset/optimizer.py``)."""

from cusrl_tpu_torch.template.optimizer import AdamFactory, AdamWFactory, SgdFactory

__all__ = ["AdamFactory", "AdamWFactory", "SgdFactory"]
