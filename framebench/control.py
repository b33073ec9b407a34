"""The control of a one-card cell's check, and the faults planted under
it, run to set and test its limits: each seed's run with the reference in
bfloat16 put in the program's place on the checked frames
(``reference.compare.control_outputs``), or with ``--fault`` the program
run with that fault planted in its timed path (``faults.py``). The
benchmark's own runs never run either.

    python3 framebench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

Prints one JSON line per seed: the seed, the fault, ``correct`` and the
numbers beside their limits.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args()
    sys.path[:] = [CHECKOUT] + [q for q in sys.path
                                if os.path.abspath(q or ".") != HERE]
    from framebench import faults
    from framebench.harness import main as harness_main, spec
    if args.fault:
        faults.plant(args.fault)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        out = harness_main.run_one(cell, seed, args.seconds, False,
                                   time.perf_counter(), "cuda",
                                   control=args.fault is None)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
