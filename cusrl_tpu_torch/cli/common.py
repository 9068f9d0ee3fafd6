"""Shared CLI plumbing (counterpart of ``cusrl_tpu/cli/common.py``).

``--device`` (default ``cuda``) is the port's counterpart of
``JAX_PLATFORMS=cpu``: the subcommands run on the card unless the caller asks
for the CPU, and without CUDA and without ``--device cpu`` they raise.
Under ``torchrun`` ``prepare_experiment`` first joins the process group
(``configure_distributed``: NCCL on the card, gloo with ``--device cpu``),
and ``--device cuda`` means ``cuda:LOCAL_RANK``.  As in the JAX package the
CLI does not call ``parallel.distribute_agent``: each rank trains its own
copy of the policy, with rank-0-only files and prints and averaged logs.
"""

from __future__ import annotations

import argparse
from typing import Any

from cusrl_tpu_torch.template.trial import Trial
from cusrl_tpu_torch.utils.cli_utils import apply_overrides
from cusrl_tpu_torch.utils.config import configure_distributed, resolve_device
from cusrl_tpu_torch.utils.misc import import_module, set_global_seed

__all__ = ["add_common_arguments", "load_trial", "prepare_experiment", "resolve_overrides"]


def add_common_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-env", "--environment", required=True, help="Environment name (zoo key prefix)")
    parser.add_argument("-alg", "--algorithm", default="ppo", help="Algorithm name (zoo key suffix)")
    parser.add_argument("--checkpoint", default=None, help="Checkpoint file / iteration / experiment dir")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--name", default=None, help="Override experiment/run name")
    parser.add_argument("-m", "--module", action="append", default=[], help="Extra experiment modules to import")
    parser.add_argument("-s", "--script", action="append", default=[], help="Extra python files to execute")
    parser.add_argument("--inherit-args", action="store_true", help="Replay recorded overrides from the trial metadata")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def prepare_experiment(args: argparse.Namespace):
    """Joins the process group under ``torchrun``, resolves the device
    (raising without CUDA unless ``--device cpu``), seeds (``seed + rank``),
    imports the extra modules and scripts; returns the experiment."""
    from cusrl_tpu_torch.zoo.registry import add_experiment_modules, get_experiment

    configure_distributed(args.device)
    args.device = resolve_device(args.device)
    if args.seed is not None:
        set_global_seed(args.seed)
    for module in args.module:
        add_experiment_modules(module)
    for script in args.script:
        import_module(path=script)
    return get_experiment(args.environment, args.algorithm)


def load_trial(args: argparse.Namespace) -> Trial | None:
    if args.checkpoint is None and not args.inherit_args:
        return None
    try:
        name = args.name or f"{args.environment}_{args.algorithm}"
        return Trial(args.log_dir, name if args.checkpoint is None else None, checkpoint=args.checkpoint)
    except FileNotFoundError:
        if args.checkpoint is not None:
            raise
        return None


def resolve_overrides(factory: Any, overrides: list[str], trial: Trial | None, inherit: bool) -> tuple[Any, dict]:
    """Applies the trial's recorded overrides (with ``inherit``), then the
    given ones."""
    merged: list[str] = []
    if inherit and trial is not None:
        for key, raw in trial.load_metadata().get("overrides", {}).items():
            merged.extend([f"--{key}", str(raw)])
    merged.extend(overrides)
    return apply_overrides(factory, merged)
