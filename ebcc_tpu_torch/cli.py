"""Command-line interface: compress / decompress / sweep / info.

Counterpart of ``ebcc_tpu.cli``: the same subcommands, flags and JSON
lines.  ``compress``, ``decompress`` and ``sweep`` run on ``--device``
("cuda", the default, which fails without a CUDA device, or "cpu");
``info`` and ``filter-string`` touch no device.

Replaces the reference's script layer (SURVEY.md §2.3): the
``EBCC_Filter`` CLI (filter_wrapper.py:84-140), the sweep scripts
(scripts/hdf5_compression_sweep.py) and the single-config timing run
(scripts/hdf5_compression.py), as subcommands of one entry point:

    python -m ebcc_tpu_torch compress IN.npy OUT.ebt --error 0.5
    python -m ebcc_tpu_torch decompress OUT.ebt REC.npy
    python -m ebcc_tpu_torch sweep IN.npy --errors 0.1 0.5 1.0 --csv out.csv
    python -m ebcc_tpu_torch info OUT.ebt
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import api
from .codec import container
from .codec.config import MODE_NAMES as _MODES
from .codec.config import EBCCConfig


def _load(path: str, dataset: str | None = None) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith((".h5", ".hdf5", ".nc")):
        import h5py
        with h5py.File(path, "r") as f:
            if dataset is not None:
                if dataset not in f:
                    raise SystemExit(f"dataset {dataset!r} not in {path} "
                                     f"(has: {', '.join(sorted(f))})")
                return np.asarray(f[dataset][:], np.float32)
            # auto-pick: prefer float 2-D+ data variables over the 2-D
            # bounds/coordinate variables netCDF files commonly carry
            def score(name, d):
                if getattr(d, "ndim", 0) < 2:
                    return None
                aux = any(t in name.lower() for t in
                          ("bnds", "bounds", "lat", "lon", "vertices"))
                isfloat = d.dtype.kind == "f"
                return (isfloat, not aux, d.size)

            best = None
            for k, d in f.items():
                s = score(k, d)
                if s and (best is None or s > best[0]):
                    best = (s, k)
            if best:
                return np.asarray(f[best[1]][:], np.float32)
        raise SystemExit(f"no 2-D dataset found in {path} "
                         "(use --dataset to name one)")
    raise SystemExit(f"unsupported input format: {path}")


def _config(args) -> EBCCConfig:
    kw = dict(mode=_MODES[args.mode], base_cr=args.base_cr)
    if args.mode in ("max_error", "relative_error"):
        kw["error"] = args.error
    return EBCCConfig(**kw)


def cmd_compress(args):
    data = _load(args.input, args.dataset)
    cfg = _config(args)
    eb = None
    if args.mode == "pointwise_max_error":
        if not args.error_bound_file:
            raise SystemExit(
                "pointwise_max_error requires --error-bound-file "
                "(per-point bound .npy, same shape as the data)")
        eb = np.load(args.error_bound_file).astype(np.float32)
    t0 = time.perf_counter()
    blob = api.compress(data, cfg, error_bound=eb, device=args.device)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(blob)
    print(json.dumps({"bytes": len(blob), "cr": data.nbytes / len(blob),
                      "seconds": dt, "MBps": data.nbytes / dt / 1e6}))


def cmd_decompress(args):
    blob = open(args.input, "rb").read()
    t0 = time.perf_counter()
    rec = api.decompress(blob, device=args.device)
    dt = time.perf_counter() - t0
    np.save(args.output, rec)
    print(json.dumps({"shape": list(rec.shape), "seconds": dt}))


def cmd_sweep(args):
    """Error-bound sweep: CR + achieved error per bound
    (scripts/hdf5_compression_sweep.py:118-170 equivalent)."""
    if args.mode == "pointwise_max_error":
        raise SystemExit("sweep sweeps scalar bounds; pointwise mode needs "
                         "per-point bounds — use scripts/pointwise_sweep.py")
    data = _load(args.input, args.dataset)
    rows = []
    for err in args.errors:
        cfg = EBCCConfig(mode=_MODES[args.mode], error=err,
                         base_cr=args.base_cr)
        t0 = time.perf_counter()
        blob = api.compress(data, cfg, device=args.device)
        enc_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = api.decompress(blob, cfg, device=args.device).reshape(
            data.shape)
        dec_t = time.perf_counter() - t0
        # one numpy pass for all statistics on the host, where both
        # arrays already are (the metric helpers in ops/metrics.py would
        # upload them to the device once per call)
        x = data.reshape(-1, *data.shape[-2:]).astype(np.float64)
        y = rec.reshape(x.shape).astype(np.float64)
        ae = np.abs(x - y)
        rng = x.max(axis=(-2, -1)) - x.min(axis=(-2, -1))
        maxe = ae.max(axis=(-2, -1))
        rmse = np.sqrt(np.mean((x - y) ** 2, axis=(-2, -1)))
        # the bound the codec actually enforced: absolute in max_error
        # mode, err * per-frame range in relative_error mode
        bound = (err * rng if args.mode == "relative_error"
                 else np.full_like(rng, err))
        within = np.mean(ae <= bound[:, None, None], axis=(-2, -1))
        rows.append(dict(
            error_target=err, cr=data.nbytes / len(blob),
            max_error=float(maxe.max()),
            rel_error=float((maxe / rng).max()),
            rmse=float(rmse.max()),
            psnr_db=float((20 * np.log10(
                rng / np.maximum(rmse, 1e-30))).min()),
            within_bound=float(within.min()),
            encode_s=enc_t, decode_s=dec_t))
        print(json.dumps(rows[-1]))
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=list(rows[0]))
            wr.writeheader()
            wr.writerows(rows)


def cmd_filter_string(args):
    """Emit the CDO --filter string, cd_values and h5py kwargs for the
    HDF5 filter integration (parity with the reference's EBCC_Filter CLI,
    filter_wrapper.py:84-140)."""
    from .wrappers import hdf5 as whdf5
    residual_opt = (args.mode, args.error)
    params = whdf5.EBCCFilterParams(
        base_cr=args.base_cr, height=args.height, width=args.width,
        residual_opt=residual_opt, data_dim=args.data_dim)
    kw = params.hdf5_kwargs()
    print(json.dumps({
        "filter_id": params.filter_id,
        "plugin_dir": whdf5._plugin_dir(),
        "cd_values": list(params.cd_values()),
        "cdo_filter": params.cdo_filter_string(),
        "cdo_usage": f"HDF5_PLUGIN_PATH={whdf5._plugin_dir()} cdo --filter "
                     f"{params.cdo_filter_string()} copy in.nc out.nc",
        "h5py_create_dataset_kwargs": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in kw.items()},
        "read": "set HDF5_PLUGIN_PATH to plugin_dir (or call "
                "register_plugin_path()) and read normally",
    }, indent=1))


def cmd_info(args):
    blob = open(args.input, "rb").read()
    frames = container.unpack_blob(blob)
    print(json.dumps({
        "frames": len(frames),
        "total_bytes": len(blob),
        "frame_bytes": [len(f) for f in frames],
    }))


def main(argv=None):
    p = argparse.ArgumentParser(prog="ebcc_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the codec runs (default: cuda)")

    def common(sp):
        device(sp)
        sp.add_argument("--mode", choices=sorted(_MODES),
                        default="max_error")
        sp.add_argument("--error", type=float, default=1e-2)
        sp.add_argument("--base-cr", type=float, default=100.0)
        sp.add_argument("--error-bound-file", default=None,
                        help=".npy per-point bounds (pointwise mode)")
        sp.add_argument("--dataset", default=None,
                        help="HDF5/netCDF dataset name (default: the "
                             "largest float 2-D+ data variable)")

    sp = sub.add_parser("compress")
    sp.add_argument("input")
    sp.add_argument("output")
    common(sp)
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress")
    sp.add_argument("input")
    sp.add_argument("output")
    device(sp)
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("sweep")
    sp.add_argument("input")
    sp.add_argument("--errors", type=float, nargs="+", required=True)
    sp.add_argument("--csv")
    common(sp)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("info")
    sp.add_argument("input")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("filter-string",
                        help="HDF5 filter integration parameters")
    sp.add_argument("--height", type=int, default=721)
    sp.add_argument("--width", type=int, default=1440)
    sp.add_argument("--mode", choices=sorted(_MODES), default="max_error")
    sp.add_argument("--error", type=float, default=1e-2,
                    help="bound / ratio / residual-CR parameter")
    sp.add_argument("--base-cr", type=float, default=100.0)
    sp.add_argument("--data-dim", type=int, default=2)
    sp.set_defaults(fn=cmd_filter_string)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
