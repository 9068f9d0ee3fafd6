"""``python -m cusrl_tpu_torch find-trial`` (counterpart of
``cusrl_tpu/cli/find_trial.py``): prints the resolved checkpoint path, run
directory or iteration, for scripting."""

from __future__ import annotations

import argparse

from cusrl_tpu_torch.template.trial import Trial

__all__ = ["configure_parser", "main"]


def configure_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-env", "--environment", default=None)
    parser.add_argument("-alg", "--algorithm", default="ppo")
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--checkpoint", default=None, help="Specific iteration to resolve")
    parser.add_argument("--what", default="checkpoint", choices=["checkpoint", "dir", "iteration"])


def main(args: argparse.Namespace, overrides: list[str]) -> None:
    name = f"{args.environment}_{args.algorithm}" if args.environment else None
    trial = Trial(args.log_dir, name, checkpoint=args.checkpoint)
    if args.what == "dir":
        print(trial.trial_dir)
    elif args.what == "iteration":
        print(trial.iteration)
    else:
        print(trial.checkpoint_path)
