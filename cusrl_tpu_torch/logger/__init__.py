from cusrl_tpu_torch.logger.backends import Jsonl, Swanlab, Tensorboard, Wandb

__all__ = ["Jsonl", "Swanlab", "Tensorboard", "Wandb"]
