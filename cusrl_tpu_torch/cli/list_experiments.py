"""``python -m cusrl_tpu_torch list-experiments`` (counterpart of
``cusrl_tpu/cli/list_experiments.py``)."""

from __future__ import annotations

import argparse

__all__ = ["configure_parser", "main"]


def configure_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-m", "--module", action="append", default=[], help="Extra experiment modules")


def main(args: argparse.Namespace, overrides: list[str]) -> None:
    from cusrl_tpu_torch.zoo.registry import add_experiment_modules, list_experiments

    for module in args.module:
        add_experiment_modules(module)
    for name in list_experiments():
        print(name)
