"""CLI dispatcher (counterpart of ``cusrl_tpu/__main__.py``).

Subcommands: train, play, benchmark, export, find-trial, list-experiments.
Factory-tree overrides follow a ``--`` separator, e.g.::

    python -m cusrl_tpu_torch train -env Velocity-Flat -alg ppo --logger jsonl -- --agent.lr 1e-4

The subcommands run on the card; ``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import sys

from cusrl_tpu_torch.cli import benchmark, export, find_trial, list_experiments, play, train
from cusrl_tpu_torch.utils.cli_utils import split_cli_overrides

_COMMANDS = {
    "train": train,
    "play": play,
    "benchmark": benchmark,
    "export": export,
    "find-trial": find_trial,
    "list-experiments": list_experiments,
}


def main(argv: list[str] | None = None):
    """Runs one subcommand; returns what it returns (the Trainer of
    ``train``, the Player of ``play`` and ``benchmark``)."""
    argv = sys.argv[1:] if argv is None else argv
    own, overrides = split_cli_overrides(argv)
    parser = argparse.ArgumentParser(prog="cusrl_tpu_torch", description=__doc__)
    subparsers = parser.add_subparsers(dest="command", required=True)
    for name, module in _COMMANDS.items():
        module.configure_parser(subparsers.add_parser(name))
    args = parser.parse_args(own)
    return _COMMANDS[args.command].main(args, overrides)


if __name__ == "__main__":
    main()
