"""What the harness's tests share: the repository's root on the path, and a
cell cut to a size a CPU test can hold (the program's plain torch versions
run it)."""

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import core  # noqa: E402

CELLS = ("z500_maxerr.archive", "t2m_pointwise.archive")
# a configuration kept for a later cell on the same mix, not in
# BENCHMARK.json (PERF.md, Open questions)
KEPT = {"t2m_pointwise.archive": "era5_t2m_pointwise"}


def small_cell(name: str, root: str = ROOT) -> core.Cell:
    """``name`` at 65 x 128 (odd, as the spread's grid needs), a pool of 8
    frames, requests of 4, batches of 2, two writers, a sample of 4."""
    if name in KEPT:
        with open(os.path.join(root, "portbench", "configs",
                               KEPT[name] + ".json")) as f:
            cell = dataclasses.replace(core.load_cell(CELLS[0], root),
                                       name=name, config=json.load(f))
    else:
        cell = core.load_cell(name, root)
    config = dict(cell.config, h=65, w=128, pool_frames=8, max_batch=2)
    traffic = dict(cell.traffic, frames_per_request=4, offset_step=2,
                   writers=2, check_frames=4,
                   trace_lead_s=0.2, trace_settle_s=0.1,
                   trace_span_s=0.3)
    return dataclasses.replace(cell, config=config, traffic=traffic)
