"""The port's benchmark: one cell, one seed, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Measures ``cusrl_tpu_torch``'s PPO
training loop (``Trainer.run_training_loop`` on the zoo entry's factory)
for the cell named in ``BENCHMARK.json`` and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers compared with their limits (also the last lines of
standard error).

``--readings K`` (not a benchmark run) runs set-up and the first chunk for
K seeds from ``--seed`` in one process and prints, per seed, the check's
numbers for the program, for the control and for each planted fault.

Exits 2 for a cell the benchmark does not list, 3 without the cards the
cell asks for, 4 when a JAX module was loaded, printing no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _arguments(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--readings", type=int, default=0)
    return parser.parse_args(argv)


def main(argv: list[str]) -> int:
    args = _arguments(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    from portbench.harness import spec

    try:
        cell = spec.load_cell(args.workload)
    except KeyError as error:
        print(error, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {count}", file=sys.stderr)
        return 3
    return _run(args, cell)


def _run(args, cell) -> int:
    import torch

    from portbench.harness import runner

    device = f"cuda:{torch.cuda.current_device()}"
    if args.readings:
        for row in runner.readings(cell, [args.seed + i for i in range(args.readings)], device):
            print(json.dumps(row), flush=True)
        return 0
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = runner.forbidden_modules()
    if found:
        print(f"JAX modules loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, entry in result["checks"].items():
        print(f"check {name}: {entry['value']} (limit {entry['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
