from cusrl_tpu_torch.cli import benchmark, export, find_trial, list_experiments, play, train

__all__ = ["benchmark", "export", "find_trial", "list_experiments", "play", "train"]
