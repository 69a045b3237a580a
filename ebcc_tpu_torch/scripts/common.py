"""What the port's entry points share: the bench recipe, the reference
frame, the device rule, the card's name and the clocks.

Every entry point runs on ``cuda`` unless ``--device cpu`` is given; asking
for ``cuda`` without a card raises (:func:`resolve_device`), as the API and
the CLI do.  Device work is timed by CUDA events on a card and by the host
clock on the CPU (where every torch call is synchronous), and every result
names the device it ran on.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from .. import api

BENCH_H, BENCH_W = 721, 1440
BENCH_ERROR, BENCH_BASE_CR = 0.5, 100
# the environment variable that names the reference frame: the ERA5 fixture
# (721x1440 float32 .npy) that the JAX drivers read from a fixed path.  The
# port reads nothing outside its checkout unless asked, so a driver reads
# the frame only where this names it.
REFERENCE_FRAME_ENV = "EBCC_REFERENCE_FRAME"


def resolve_device(name) -> torch.device:
    """``name`` as a torch device; "cuda" without a card raises."""
    return api._device(name)


def add_device_args(p: argparse.ArgumentParser, data: bool = True) -> None:
    """The flags every entry point takes: ``--device`` and, where the
    measuring entry points' JAX script reads a frame from a file,
    ``--data``."""
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the codec runs (cuda raises without a card)")
    if data:
        p.add_argument("--data", default=None, metavar="FRAME.npy",
                       help="a 2-D float32 frame the frames are made from "
                            "(default: the synthetic recipe)")


def reference_path() -> str | None:
    """The file ``$EBCC_REFERENCE_FRAME`` names, or None where it is unset."""
    return os.environ.get(REFERENCE_FRAME_ENV) or None


def reference_or_synthetic() -> np.ndarray:
    """The reference frame where one is named, else the synthetic 721x1440
    field of :func:`base_frame` (the JAX drivers' fallback)."""
    path = reference_path()
    return (np.load(path).astype(np.float32) if path
            else base_frame()[0])


def base_frame(h: int = BENCH_H, w: int = BENCH_W,
               path: str | None = None) -> tuple[np.ndarray, str]:
    """The frame the bench's stack is made from, and what it is: the 2-D
    array in ``path``, else bench.py's synthetic field (a smooth
    latitude/longitude pattern around 260)."""
    if path is not None:
        base = np.load(path).astype(np.float32)
        if base.ndim != 2:
            raise ValueError(f"{path}: a 2-D frame is needed, got shape "
                             f"{base.shape}")
        return base, f"frame from {path} {base.shape[0]}x{base.shape[1]}"
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    return base, f"synthetic recipe {h}x{w}"


def bench_frames(n: int, h: int = BENCH_H, w: int = BENCH_W, seed: int = 0,
                 base: np.ndarray | None = None) -> np.ndarray:
    """bench.py's stack: ``n`` frames of ``base`` (default the synthetic
    field) plus N(0, 0.05) noise drawn in order from one generator of
    ``seed``, so frame i is the same in every stack of more than i
    frames."""
    if base is None:
        base, _ = base_frame(h, w)
    rng = np.random.default_rng(seed)
    return np.stack([base + rng.normal(0, 0.05, base.shape).astype(
        np.float32) for _ in range(n)])


def card_line(device: torch.device) -> str | None:
    """nvidia-smi's ``name, power.limit`` of the card, or the device name
    where nvidia-smi cannot be run; None on the CPU."""
    if device.type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device) + ", power limit not read"


def device_kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timing(device: torch.device) -> str:
    return ("cuda events" if device.type == "cuda" else
            "host clock (cpu)")


def mean_seconds(fn, reps: int, device: torch.device) -> float:
    """Mean seconds of ``fn()`` over ``reps`` calls after one warm call: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


# warm calls before a timed one: a graphed codec stage runs eagerly at its
# key's first call and captures its CUDA graph at the second
WARM_CALLS = 2


def best_seconds(fn, reps: int, device: torch.device) -> float:
    """Least seconds of one ``fn()`` call over ``reps`` calls after
    :data:`WARM_CALLS` warm calls: CUDA events around each call on a card
    (from the first launch to the end of the last, host gaps between them
    included), the host clock on the CPU."""
    for _ in range(WARM_CALLS):
        fn()
    sync(device)
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def best_wall(fn, reps: int, device: torch.device) -> float:
    """Least host seconds of ``fn()`` followed by a synchronise, over
    ``reps`` calls after :data:`WARM_CALLS` warm calls."""
    for _ in range(WARM_CALLS):
        fn()
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


class Marks:
    """Time between successive points of one run, summed by name: a CUDA
    event at each point on a card (device time, gaps included), the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points = [self._now()]
        self.names: list[str] = []

    def _now(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def mark(self, name: str) -> None:
        """Close the interval since the previous point as ``name``."""
        self.points.append(self._now())
        self.names.append(name)

    def seconds(self) -> dict[str, float]:
        """{name: summed seconds}; on a card it waits for the events."""
        if self.cuda:
            self.points[-1].synchronize()
        out: dict[str, float] = {}
        for name, a, b in zip(self.names, self.points, self.points[1:]):
            dt = (a.elapsed_time(b) / 1e3 if self.cuda else b - a)
            out[name] = out.get(name, 0.0) + dt
        return out
