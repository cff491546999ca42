"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python -m flowbench.calibrate --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 4

For each seed (1001, 1002, ... unless ``--first-seed`` says otherwise)
one run of the cell as the benchmark runs it, with a short window at the
cell's own load, all in one process: the program as its configuration
states it (float32), and, on the first ``--control-seeds`` seeds, the
control on the same frames: the program's own next lower precision
switched on (``DISConfig(dtype="bfloat16")``: K2's bf16 operands).  The
two runs of a seed share the reference's chain.  Prints each run's
numbers of ``check.STATS`` and, per number, the largest the program read
(the lower reading) and the smallest the control read (the upper
reading).  ``--chained N`` compares a stream's first N flows against the
reference's own chain instead of the mix's count (a one-off look along a
whole ring).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import sys

from .reference.check import STATS
from .run import log, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=1001)
    ap.add_argument("--chained", type=int, default=None)
    args = ap.parse_args(argv)
    mix = None if args.chained is None else {"chained": args.chained}
    readings = {}
    for n, seed in enumerate(range(args.first_seed,
                                   args.first_seed + args.seeds)):
        memo = {}
        sides = [("program", {})]
        if n < args.control_seeds:
            sides.append(("control", {"dtype": "bfloat16"}))
        for side, changes in sides:
            got = []
            run_cell(args.workload, seed, args.seconds, False,
                     changes=changes, memo=memo, readings_out=got,
                     mix_changes=mix)
            values = {k: got[0].worst(k) for k in STATS}
            for k, v in values.items():
                readings.setdefault((side, k), []).append(v)
            log(f"calibrate {side} seed {seed}: " + " ".join(
                f"{k} {v:.4g}" for k, v in values.items()))
    for (side, k), vals in sorted(readings.items()):
        which, value = (("lower", max(vals)) if side == "program"
                        else ("upper", min(vals)))
        print(f"{args.workload} {side} {k}: {which} {value:.6g} over "
              f"{len(vals)} seeds: " + " ".join(f"{v:.3g}" for v in vals),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
