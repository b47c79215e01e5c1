"""A witness of the engine's mirror fill, which a protein cell fails.

The engine keeps a segment pair's value under both orders of the pair
(taxtk_torch/engine/executor.py, `_align_round`), and RPA then reads the
value of one order where taxator-tk realigns the pair in that order.  A
protein alignment's traceback counts depend on the order, so the two
values can differ.  This runs a cell twice on each seed, once as it is and
once with the mirror fill switched off (every pair asked for is then
aligned by the program in the order asked), and prints both runs' compared
numbers:

    python3 taxbench/witness.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

A run as it is that differs from the reference, beside a run without the
mirror fill that agrees with it, places the fault in the mirror fill.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from taxbench import run  # noqa: E402


class Unmirrored(dict):
    """A pair cache whose setdefault, which only the mirror fill calls,
    stores nothing."""

    def setdefault(self, key, default=None):
        return self.get(key, default)


def no_mirror(**_):
    """Every pair cache of a round stores nothing under the other order."""
    def unmirror(args):
        caches = args["pair_caches"]
        for ti, cache in enumerate(caches):
            if not isinstance(cache, Unmirrored):
                caches[ti] = Unmirrored(cache)

    return run.around_align_round(before=unmirror)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seed:
        for mirror in (True, False):
            res = run.run_cell(args.workload, seed, args.seconds, 0,
                               device=device,
                               fault=None if mirror else no_mirror)
            print(json.dumps(dict(
                workload=args.workload, seed=seed, device=device,
                mirror_fill=mirror, correct=res["correct"],
                **{k: c["value"] for k, c in res["checks"].items()})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
