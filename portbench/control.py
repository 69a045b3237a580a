"""Readings of the correctness check at a cell's own size, in one process:
the program's own runs on many seeds (the lower readings), the control
and the planted faults (``faults.py``) on a few (the upper readings).
Not part of a benchmark run.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

Prints one JSON line per window: what ran, its seed, ``correct``, the
numbers compared and the rate.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import core, faults, loadgen  # noqa: E402


def reading(s, what, seconds):
    out = core.measure(s, seconds, False)
    line = {"what": what, "seed": s.seed, "correct": out["correct"],
            "attempted": out["attempted"], "failed": out["failed"],
            "checks": {k: v["value"] for k, v in out["checks"].items()},
            "write_mpts_per_s": out["metrics"].get(
                "write_mpts_per_s", {}).get("value")}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = core.load_cell(a.workload)
    s = core.prepare(cell, a.seeds[0])
    sound = s.fn

    def with_seed(seed, fn):
        s.seed, s.fn = seed, fn
        s.plan = loadgen.Plan(cell.traffic, cell.config["pool_frames"],
                              seed)

    for seed in a.seeds:
        with_seed(seed, sound)
        reading(s, "program", a.seconds)
    for name, make in {**faults.CONTROL, **faults.FAULTS}.items():
        for seed in a.control_seeds:
            with_seed(seed, make(cell.config)(sound))
            reading(s, name, a.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
