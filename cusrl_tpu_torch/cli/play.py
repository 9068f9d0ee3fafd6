"""``python -m cusrl_tpu_torch play`` (counterpart of ``cusrl_tpu/cli/play.py``):
the Player, paced in real time.  Returns the Player."""

from __future__ import annotations

import argparse

from cusrl_tpu_torch.cli.common import add_common_arguments, load_trial, prepare_experiment, resolve_overrides

__all__ = ["configure_parser", "main"]


def configure_parser(parser: argparse.ArgumentParser) -> None:
    add_common_arguments(parser)
    parser.add_argument("--num-steps", type=int, default=None)
    parser.add_argument("--num-episodes", type=int, default=None)
    parser.add_argument("--stochastic", action="store_true", help="Sample actions instead of the mode")
    parser.add_argument("--quiet", action="store_true")


def main(args: argparse.Namespace, overrides: list[str]):
    spec = prepare_experiment(args)
    trial = load_trial(args)
    factory, _ = resolve_overrides(spec.to_playing_factory(), overrides, trial, args.inherit_args)
    if args.num_steps is not None:
        factory.num_steps = args.num_steps
    if args.num_episodes is not None:
        factory.num_episodes = args.num_episodes
    factory.deterministic = not args.stochastic
    checkpoint = trial.load_checkpoint() if trial is not None else None
    player = factory(checkpoint=checkpoint, verbose=not args.quiet, device=args.device)
    player.run_playing_loop()
    return player
