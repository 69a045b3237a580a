"""The writer count W of a cell: its rate at each count, in one process.
Not part of a benchmark run.

    python3 portbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --counts 1 2 4 8 --rounds 3

Counts above the cores the process may use are left out.  Windows go in
rounds, the order of the counts reversed every other round.  Prints one
JSON line per window, then each count's median and quartiles of
``write_mpts_per_s`` and the smallest count whose median is within the
best count's quartile spread of the best median.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import core, loadgen  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--counts", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)
    cell = core.load_cell(a.workload)
    s = core.prepare(cell, a.seed)
    cores = len(os.sched_getaffinity(0))
    counts = [c for c in a.counts if c <= cores]
    rate = core.reader("write_mpts_per_s")
    rates = {c: [] for c in counts}
    for rnd in range(a.rounds):
        for c in counts if rnd % 2 == 0 else counts[::-1]:
            s.plan.writers = c
            loadgen.warm(s.fn, s.inputs, s.plan)
            ctx = core.Context()
            ctx.window = loadgen.window(s.fn, s.inputs, s.plan, a.seconds)
            ctx.points_per_frame = cell.config["h"] * cell.config["w"]
            rates[c].append(rate(ctx))
            print(json.dumps({"writers": c, "round": rnd,
                              "write_mpts_per_s": rates[c][-1],
                              "requests": len(ctx.window.requests)}),
                  flush=True)
    summary = {}
    for c, v in rates.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        summary[c] = {"median": statistics.median(v), "q1": q[0],
                      "q3": q[2]}
    best = max(summary, key=lambda c: summary[c]["median"])
    spread = summary[best]["q3"] - summary[best]["q1"]
    pick = min(c for c in counts
               if summary[c]["median"] >= summary[best]["median"] - spread)
    print(json.dumps({"cores": cores, "summary": summary, "best": best,
                      "writers": pick}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
