"""Speed probe of the inverse DWT and its primitives on one CUDA device.

    python -m ebcc_tpu_torch.scripts.idwt_probe [--device cpu]

The port of ``scripts/pallas_idwt_probe.py`` (p0-p5) and
``scripts/pallas_idwt_probe2.py`` (q1-q3 and the XLA reference row) at
their 768x1472 frame: for B = 1 and B = 16 frames, one JSON line per
probe, in their order.  p0-p3 and q1
launch the kernels of ``ops/idwt_probe.py``; p4/q2 and p5/q3 launch the
inverse-DWT kernel of ``ops/idwt.py`` at 1 and 5 levels;
``torch_idwt2d_multi`` times the plain torch 5-level inverse, the
counterpart of ``xla_idwt2d_multi_b1``.

Each line: ``probe``, ``kernel`` (the C entry's name; null for the plain
row), ``batch``, ``shape``, ``per_pass_s`` (the mean of 20 warm calls,
timed with CUDA events; at B = 1 that is the host's dispatch rate more
than the kernel's time), ``eff_gbps`` (2 x the frames' bytes over
that time, as the JAX scripts count), ``maxdiff`` (largest |kernel - plain
version| on the same input), ``reads`` ("L2" when one read and one write
of the frames fit in the card's L2 cache, so the time is not HBM's, else
"HBM"), ``device`` and ``card`` (nvidia-smi's name and power limit).

The input is N(0, 1) f32 from seed 0.  It runs on the card unless
``--device cpu`` is given: then every probe runs its plain version, timed
on the host clock.  Exits 1 if a kernel differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import dwt
from ..ops import idwt_probe as ip
from .common import card_line, mean_seconds

BATCHES, HEIGHT, WIDTH, REPS = (1, 16), 768, 1472, 20

# (probe row, probe kernel name or inverse-DWT levels); rows p4/q2 and
# p5/q3 time the same kernel, as their TPU probes computed the same function
ROWS = [("p0_elementwise", "probe_elementwise"),
        ("p1_sublane_interleave", "probe_row_interleave"),
        ("p2_lane_interleave", "probe_lane_interleave"),
        ("p3_transpose", "probe_transpose"),
        ("p4_one_level_idwt2d", 1),
        ("p5_full_idwt2d_multi", 5),
        ("q1_reshape_interleave", "probe_row_pairs"),
        ("q2_one_level", 1),
        ("q3_full_multi", 5)]


def run(device: torch.device, batches=BATCHES, height: int = HEIGHT,
        width: int = WIDTH, reps: int = REPS) -> list[dict]:
    """Every probe row at every batch size on ``device``, printed as JSON
    lines as they are measured; returns the rows."""
    card = card_line(device)
    l2 = (getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                  0) if device.type == "cuda" else 0)
    rows = []
    for batch in batches:
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (batch, height, width)).astype(np.float32)).to(device)
        reads = (None if device.type != "cuda" else
                 "L2" if 2 * x.nbytes <= l2 else "HBM")
        for name, what in ROWS + [("torch_idwt2d_multi", None)]:
            if what is None:
                kernel = None
                fn = lambda: dwt.idwt2d_multi_ref(x, 5)  # noqa: E731
            elif isinstance(what, int):
                kernel = "idwt"
                fn = lambda lv=what: dwt.idwt2d_multi(x, lv)  # noqa: E731
                ref = dwt.idwt2d_multi_ref(x, what)
            else:
                kernel = what
                fn = lambda p=what: ip.probe(p, x)  # noqa: E731
                ref = ip.PLAIN[what](x)
            row = {"probe": name, "kernel": kernel, "batch": batch,
                   "shape": [batch, height, width]}
            if kernel is not None:
                row["maxdiff"] = float((fn() - ref).abs().max())
                del ref
            t = mean_seconds(fn, reps, device)
            row.update(per_pass_s=t, eff_gbps=2 * x.nbytes / t / 1e9,
                       reads=reads, device=str(device), card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    rows = run(device)
    return 1 if any(r.get("maxdiff", 0.0) != 0.0 for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
