"""``python -m cusrl_tpu_torch benchmark`` (counterpart of
``cusrl_tpu/cli/benchmark.py``): the Player with no real-time pacing,
reporting its summary.  Returns the Player."""

from __future__ import annotations

import argparse

from cusrl_tpu_torch.cli.common import add_common_arguments, load_trial, prepare_experiment, resolve_overrides

__all__ = ["configure_parser", "main"]


def configure_parser(parser: argparse.ArgumentParser) -> None:
    add_common_arguments(parser)
    parser.add_argument("--num-steps", type=int, default=1000)


def main(args: argparse.Namespace, overrides: list[str]):
    spec = prepare_experiment(args)
    trial = load_trial(args)
    factory, _ = resolve_overrides(spec.to_benchmarking_factory(), overrides, trial, args.inherit_args)
    factory.num_steps = args.num_steps
    checkpoint = trial.load_checkpoint() if trial is not None else None
    player = factory(checkpoint=checkpoint, verbose=True, device=args.device)
    player.run_playing_loop()
    return player
