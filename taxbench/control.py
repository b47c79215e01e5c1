"""The control of the benchmark's comparison: the plain reference put in
the program's place, its values computed one precision below the float32
the configurations state (rounded through bfloat16).  A run of the cell
whose engine reads, for the checked contigs, the control's value of every
pair it asks for, judged by run.py's own comparison; the comparison is
sound only if this run comes out not correct.

    python3 taxbench/control.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

prints, per seed, one JSON line with `correct` and the compared numbers.
It runs at the cell's own size, on the card when there is one; the
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from collections import namedtuple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from taxbench import run  # noqa: E402
from taxbench.reference import Reference  # noqa: E402

Value = namedtuple("Value", "distance similarity")


@contextlib.contextmanager
def reference_in_place(files, contigs, config, device):
    """Each align round of the engine ends with the control's value in
    every key that a checked contig's task asked for."""
    values = Reference(files, config["protein"], device=device,
                       control="bfloat16",
                       exclude_factor=config["exclude_factor"],
                       toppercent=config["toppercent"],
                       min_support=config["binner_min_support"],
                       majority=config["binner_majority"]
                       ).check(contigs)["pairs"]
    checked = set(contigs)

    def fill(args):
        for ti, task in enumerate(args["tasks"]):
            if task.qid in checked:
                for key in args["reqs_per_task"][ti]:
                    args["pair_caches"][ti][key] = Value(
                        *values[run.reference_key(task, key)])

    with run.around_align_round(after=fill):
        yield


def readings(cell, seed, seconds, device, traffic=None):
    """One run of the cell with the control in the program's place."""
    return run.run_cell(cell, seed, seconds, 0, device=device,
                        traffic=traffic, fault=reference_in_place)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seed:
        res = readings(args.workload, seed, args.seconds, device)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, device=device,
            correct=res["correct"],
            **{k: c["value"] for k, c in res["checks"].items()})),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
