"""``python -m cusrl_tpu_torch export`` (counterpart of ``cusrl_tpu/cli/export.py``):
the actor's deployment graph (``export.py``), by default as a
``torch.export`` program (``graph.pt2``)."""

from __future__ import annotations

import argparse

from cusrl_tpu_torch.cli.common import add_common_arguments, load_trial, prepare_experiment, resolve_overrides
from cusrl_tpu_torch.export import FORMATS

__all__ = ["configure_parser", "main"]


def configure_parser(parser: argparse.ArgumentParser) -> None:
    add_common_arguments(parser)
    parser.add_argument("--output", "-o", required=True, help="Output directory")
    parser.add_argument("--format", default="torch_export", choices=FORMATS)
    parser.add_argument("--batch-size", type=int, default=1)


def main(args: argparse.Namespace, overrides: list[str]) -> None:
    spec = prepare_experiment(args)
    trial = load_trial(args)
    factory, _ = resolve_overrides(spec.to_playing_factory(), overrides, trial, args.inherit_args)
    environment = factory.environment_factory(**{**factory.environment_kwargs, "device": args.device})
    agent = factory.agent.from_environment(environment, device=args.device)
    if trial is not None and (checkpoint := trial.load_checkpoint()) is not None:
        agent.load_state_dict(checkpoint.get("agent", checkpoint))
    agent.export(args.output, target_format=args.format, batch_size=args.batch_size)
