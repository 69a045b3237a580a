"""Convert a netCDF/HDF5 file into an EBCC-filtered HDF5 file.

    python -m ebcc_tpu_torch.scripts.nc_to_ebcc_h5 IN.nc OUT.h5
        [--mode relative_error|max_error] [--error 0.009] [--base-cr 100]
        [--device [cuda|cpu|plugin]]

The port of ``scripts/nc_to_ebcc_h5.py`` (parity with the reference's
conversion layer, xarray_to_hdf5.py + hdf5_compression.py): every float
dataset with >= 2 trailing spatial dims of at least 4 is rewritten
through the EBCC HDF5 filter; everything else (coordinates, attributes)
is copied verbatim, apart from HDF5 object-reference attributes (netCDF's
DIMENSION_LIST / REFERENCE_LIST), which point into the source file.
netCDF4 files are HDF5, so h5py reads them directly.

``--device`` says where the chunks are compressed.  ``cuda`` (the
default; also a bare ``--device``, the JAX script's switch for its device
route) and ``cpu`` run one ``compress`` of the dataset on that device and
store its frames with ``write_direct_chunk``; ``plugin`` writes the data
through the filter plugin's native CPU encoder, chunk by chunk (the JAX
script's default).  The chunks are byte-equal on either route.  The JAX
script defaults to the plugin; the port's entry points run on the card
unless asked otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .. import api
from ..codec import container
from ..wrappers import hdf5 as whdf5
from . import common

_MODE_NAMES = {"max_error": "max_error_target",
               "relative_error": "relative_error_target"}


def copy_attrs(src_obj, dst_obj):
    """Copy attributes, skipping HDF5 object-reference attributes
    (netCDF's DIMENSION_LIST/REFERENCE_LIST point at objects of the
    SOURCE file; copying the raw references would leave dangling tokens in
    the output)."""
    import h5py
    for k in src_obj.attrs:
        if h5py.check_ref_dtype(src_obj.attrs.get_id(k).dtype):
            continue
        v = src_obj.attrs[k]
        if isinstance(v, h5py.Reference) or (
                isinstance(v, np.ndarray) and v.dtype == object):
            continue
        dst_obj.attrs[k] = v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.nc_to_ebcc_h5",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--mode", default="relative_error",
                   choices=list(_MODE_NAMES))
    p.add_argument("--error", type=float, default=0.009)
    p.add_argument("--base-cr", type=float, default=100.0)
    p.add_argument("--device", nargs="?", const="cuda", default="cuda",
                   choices=("cuda", "cpu", "plugin"),
                   help="compress with one compress() on cuda (default; "
                        "raises without a card) or cpu, or through the "
                        "filter plugin's CPU encoder chunk by chunk")
    args = p.parse_args(argv)
    if args.device != "plugin":
        common.resolve_device(args.device)  # raises without a card

    import h5py

    whdf5.register_plugin_path()
    mode_name = _MODE_NAMES[args.mode]

    stats = []
    with h5py.File(args.input, "r") as src, \
            h5py.File(args.output, "w") as dst:
        def visit(name, obj):
            if isinstance(obj, h5py.Group):
                copy_attrs(obj, dst.require_group(name))
                return
            if not isinstance(obj, h5py.Dataset):
                # committed datatypes etc. — nothing to copy
                print(f"skipping non-dataset object {name!r}",
                      file=sys.stderr)
                return
            if (obj.dtype.kind == "f" and obj.ndim >= 2 and
                    obj.shape[-1] >= 4 and obj.shape[-2] >= 4):
                data = np.asarray(obj[...], np.float32)
                params = whdf5.EBCCFilterParams(
                    base_cr=args.base_cr, height=data.shape[-2],
                    width=data.shape[-1], data_dim=data.ndim,
                    residual_opt=(mode_name, args.error))
                t0 = time.perf_counter()
                # the dataset keeps the source SHAPE on every route; only
                # where the chunks are compressed differs
                d = whdf5.create_filtered_dataset(dst, name, data.shape,
                                                  params)
                if args.device == "plugin":
                    d[...] = data  # plugin CPU encoder per chunk
                else:
                    blob = api.compress(data, params.to_config(),
                                        device=args.device)
                    for idx, fb in zip(np.ndindex(data.shape[:-2]),
                                       container.unpack_blob(blob)):
                        d.id.write_direct_chunk((*idx, 0, 0), fb,
                                                filter_mask=0)
                dt = time.perf_counter() - t0
                stored = d.id.get_storage_size()
                stats.append(dict(name=name, bytes=int(stored),
                                  raw_bytes=int(data.nbytes),
                                  cr=data.nbytes / max(stored, 1),
                                  seconds=round(dt, 2)))
                print(json.dumps(stats[-1]))
            else:
                d = dst.create_dataset(name, data=obj[...])
            copy_attrs(obj, d)

        src.visititems(visit)
        copy_attrs(src, dst)
    total_raw = sum(s["raw_bytes"] for s in stats)
    total_stored = sum(s["bytes"] for s in stats)
    print(json.dumps({"datasets": len(stats),
                      "total_cr": total_raw / max(total_stored, 1),
                      "output_bytes": os.path.getsize(args.output)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
