"""``python -m cusrl_tpu_torch train`` (counterpart of ``cusrl_tpu/cli/train.py``).

Writes the run directory ``<log-dir>/<timestamp>_<env>_<alg>/{info,ckpt}``
with the overrides recorded in ``info/metadata.json``; ``--checkpoint``
resumes.  The GPU machine has no tensorboard: use ``--logger jsonl`` (or
``none``) there.  Returns the Trainer."""

from __future__ import annotations

import argparse

from cusrl_tpu_torch.cli.common import add_common_arguments, load_trial, prepare_experiment, resolve_overrides
from cusrl_tpu_torch.template.logger import LoggerFactory

__all__ = ["configure_parser", "main"]


def configure_parser(parser: argparse.ArgumentParser) -> None:
    add_common_arguments(parser)
    parser.add_argument("--logger", default="tensorboard", help="Logger backend (tensorboard/jsonl/wandb/swanlab/none)")
    parser.add_argument("--num-iterations", type=int, default=None)
    parser.add_argument("--quiet", action="store_true")


def main(args: argparse.Namespace, overrides: list[str]):
    spec = prepare_experiment(args)
    trial = load_trial(args)
    factory = spec.to_training_factory()
    factory, applied = resolve_overrides(factory, overrides, trial, args.inherit_args)
    if args.num_iterations is not None:
        factory.num_iterations = args.num_iterations
    backend = None if args.logger in (None, "none") else args.logger
    trainer = factory(
        logger_factory=LoggerFactory(backend=backend, log_dir=args.log_dir),
        experiment_name=args.name or spec.experiment_name,
        checkpoint=trial.load_checkpoint() if trial is not None else None,
        metadata={"experiment": spec.experiment_name, "overrides": applied},
        verbose=not args.quiet,
        device=args.device,
    )
    trainer.run_training_loop()
    return trainer
