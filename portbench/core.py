"""One run of one cell: find it by name, make its inputs, warm it up,
measure the window, read its metrics, check what the window produced.

Everything that belongs to one configuration, traffic mix or metric sits
in files of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``generators/<generator>.py`` (named by the configuration) and
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number, or None
where it finds nothing to read).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

from portbench import loadgen, trace
from portbench.reference import check

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PROGRAM = "ebcc_tpu_torch"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "ebcc_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # the manifest's metric entries this cell reports
    per_layer: list
    root: str = ROOT     # the checkout whose files describe the cell


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    man = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = cells[name]
    here = os.path.join(root, "portbench")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]),
                _json(os.path.join(here, "configs", w["config"] + ".json")),
                _json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                mine(man["end_to_end"]), mine(man["per_layer"]), root)


def _module(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` of the checkout ``root``."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    return _module(root, "metrics", metric).read


def make_inputs(config: dict, root: str = ROOT) -> dict:
    """The pool: frames [pool_frames, h, w] (and the per-point ``bound`` of
    a pointwise configuration), float32 in host memory, from the
    configuration's own field seed.  The content is the same for every
    run's seed: the seed orders the requests and draws the check's sample,
    so every seed asks for the same work."""
    gen = _module(root, "generators", config["generator"])
    return gen.make(config["field_seed"], config["pool_frames"],
                    config["h"], config["w"], config["generator_params"])


def codec_config(config: dict):
    from ebcc_tpu_torch import EBCCConfig, ResidualMode
    fields = {f.name for f in dataclasses.fields(EBCCConfig)}
    kw = {k: v for k, v in config.items() if k in fields and k != "mode"}
    return EBCCConfig(mode=ResidualMode[config["mode"].upper()], **kw)


def compressor(config: dict, device):
    """What one request runs: ``api.compress`` of a stack."""
    import torch
    from ebcc_tpu_torch import api
    cfg = codec_config(config)

    def compress(stack, bound):
        with torch.profiler.record_function(trace.REQUEST_MARK):
            return api.compress(stack, cfg, error_bound=bound,
                                device=device)

    return compress


def levels(config: dict) -> tuple:
    """(base, residual) DWT levels as the program clamps them to the
    frame."""
    lim = max(0, (min(config["h"], config["w"]) - 1).bit_length() - 2)
    cfg = codec_config(config)
    return min(cfg.base_levels, lim), min(cfg.residual_levels, lim)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"


def host_cpu_times() -> list | None:
    """The machine's CPU times (``/proc/stat``: user, nice, system, idle,
    iowait, irq, softirq, steal), or None where there is no such file."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def log_window(win, cpu_s, host_close, host_open) -> None:
    """One line on the window: its requests' durations, this process's CPU
    time and what the whole machine's CPUs did meanwhile."""
    d = sorted(r.end - r.start for r in win.requests)
    q = [d[int(f * (len(d) - 1))] for f in (0.25, 0.5, 0.75)] if d else []
    mid = (win.open + win.close) / 2
    halves = [loadgen.frames_within(win, lo, hi) / (hi - lo)
              for lo, hi in ((win.open, mid), (mid, win.close))
              if hi > lo]
    line = (f"window: {win.close - win.open:.3f} s, {len(d)} requests, "
            "frames/s by half " + "/".join(f"{v:.1f}" for v in halves)
            + ", "
            f"durations q1/median/q3 " + "/".join(f"{v:.3f}" for v in q)
            + f" s; this process {cpu_s:.1f} CPU s")
    if host_close and host_open:
        dt = [a - b for a, b in zip(host_close, host_open)]
        tot = sum(dt) or 1
        line += (f"; machine busy {100 * (tot - dt[3] - dt[4]) / tot:.1f} %,"
                 f" steal {100 * dt[7] / tot:.1f} %, load "
                 + " ".join(f"{v:.2f}" for v in os.getloadavg()))
    log(line)


class Context:
    """What the metric readers read."""


@dataclasses.dataclass
class Session:
    """A cell made ready to measure: its inputs, its plan, the warm timed
    path."""
    cell: Cell
    seed: int
    device: object
    inputs: dict
    plan: loadgen.Plan
    fn: object


def prepare(cell: Cell, seed: int, device: str = "cuda", wrap=None,
            t0: float | None = None, traced: bool = False) -> Session:
    """Set-up: the program, the inputs, the warm-up.  ``wrap(compress)``
    puts something else in the timed path's place (the control, the
    faults)."""
    t0 = time.perf_counter() if t0 is None else t0
    config = cell.config
    os.environ.update(config.get("env", {}))
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    fn = compressor(config, dev)
    log(f"set-up: torch, the program and the device at "
        f"{time.perf_counter() - t0:.3f} s")
    t = time.perf_counter()
    inputs = make_inputs(config, cell.root)
    log(f"generator {config['generator']}: {config['pool_frames']} frames "
        f"of {config['h']}x{config['w']} in {time.perf_counter() - t:.3f} s")
    plan = loadgen.Plan(cell.traffic, config["pool_frames"], seed)
    if wrap is not None:
        fn = wrap(fn)
    t = time.perf_counter()
    warm = loadgen.warm(fn, inputs, plan)
    failed = [r.error for r in warm if r.error]
    if failed:
        raise RuntimeError(f"warm request failed: {failed[0]}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if traced:
            trace.warm_up(dev)
    log("set-up: warm requests " + ", ".join(
        f"{r.end - r.start:.3f}" for r in warm) + " s; all "
        f"{time.perf_counter() - t:.3f} s")
    return Session(cell, seed, dev, inputs, plan, fn)


def run(cell: Cell, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", t0: float | None = None, wrap=None) -> dict:
    """One run; returns the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    s = prepare(cell, seed, device, wrap, t0, traced)
    return measure(s, seconds, traced, time.perf_counter() - t0)


def measure(s: Session, seconds: float, traced: bool,
            setup_s: float | None = None) -> dict:
    """The window, its metrics and the check of what it produced."""
    import torch
    cell, dev = s.cell, s.device
    config, traffic = cell.config, cell.traffic
    ctx = Context()
    ctx.setup_s = setup_s
    tr = {}

    def during(open_t, deadline, gate):
        ctx.cpu_open = trace.cpu_seconds()
        ctx.host_open = host_cpu_times()
        if traced:
            tr["capture"] = trace.capture(open_t, deadline, traffic, gate)

    win = loadgen.window(s.fn, s.inputs, s.plan, seconds, during)
    ctx.cpu_close = trace.cpu_seconds()
    log_window(win, ctx.cpu_close - ctx.cpu_open,
               host_cpu_times(), ctx.host_open)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx.config, ctx.traffic, ctx.window = config, traffic, win
    ctx.trace = trace.load(tr.get("capture"))
    ctx.points_per_frame = config["h"] * config["w"]
    ctx.levels = levels(config)
    ctx.device_kind = (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")
    ctx.port_kernels = trace.port_kernels(os.path.join(ROOT, PROGRAM,
                                                       "csrc"))
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        v = reader(m["name"], cell.root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": ctx.device_kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    out = {"attempted": len(win.requests),
           "failed": sum(1 for r in win.requests if r.error),
           "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.window_s()
        out["breakdown"] = trace.breakdown(
            ctx.trace, [(r.start, r.end) for r in win.requests])
    for r in win.requests:
        if r.error:
            log(f"request {r.writer}.{r.index} failed: {r.error}")
    # the reference runs after the window, the peak read and the trace
    # freed, on the card the program ran on
    tr.clear()
    ctx.trace = None
    gc.collect()
    t = time.perf_counter()
    checks = check.check(win.requests, s.inputs, config, s.plan.frames,
                         s.seed, int(traffic["check_frames"]), dev)
    log(f"reference check: {time.perf_counter() - t:.3f} s")
    out["correct"] = (out["attempted"] > 0 and out["failed"] == 0
                      and all(c["value"] is not None
                              and c["value"] <= c["limit"]
                              for c in checks.values()))
    out["checks"] = checks
    out["window"] = win
    return out


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def main(workload: str, seed: int, seconds: float, traced: bool,
         t0: float) -> int:
    cell = load_cell(workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    out = run(cell, seed, seconds, traced, t0=t0)
    bad = forbidden_modules()
    if bad:
        log("modules of JAX or the JAX package loaded: " + ", ".join(bad))
        return 3
    log(f"card: {card_line()}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    # the checks last in the line, as the numbers compared
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device", "breakdown") if k in out}
    line["checks"] = out["checks"]
    print(json.dumps(line), flush=True)
    return 0
