"""HDF5 integration: store EBCC containers inside HDF5 files.

Counterpart of ``ebcc_tpu.wrappers.hdf5``.  Files cross between the two
packages: the attribute key (``"ebcc_tpu"``), its JSON and the filter ids
are the JAX package's, and the two ``EBCCConfig`` classes have the same
fields, so a dataset written by either package reads in the other.

The reference integrates as an HDF5 *filter plugin* (filters 308/310,
h5z_j2k.c:26-40) configured through ``EBCC_Filter``
(filter_wrapper.py:19-82), so any HDF5 writer/reader with the plugin on
``HDF5_PLUGIN_PATH`` compresses on write and sees a normal float dataset
on read.

This framework offers the same integration at three levels:

* **Filter plugins** (ids 33076/33077/33078 = reference 308/310/309):
  full write + read through libhdf5, backed by the standalone CPU codec
  (native/ebcc_cpu_encoder.cc / ebcc_cpu_decoder.cc) — works from h5py,
  CDO, netCDF, anything.  :func:`create_filtered_dataset` /
  ``EBCCFilterParams.hdf5_kwargs`` wire a dataset to them.
* **Device-accelerated chunk writes**: :func:`write_filtered_dataset`
  compresses on the card and stores the chunks directly (same on-disk
  format; byte-identical to the plugin's own writes).
* **Opaque-dataset helpers**: :func:`write_dataset` / :func:`read_dataset`
  store a whole container blob as a uint8 dataset with self-describing
  attrs (no plugin needed to copy files around).

Every function that compresses or decompresses takes ``device``: "cuda"
(the default; raises without a CUDA device) or "cpu".

:class:`EBCCFilterParams` keeps the ``EBCC_Filter`` construction surface
(dataset name, shape, bound mode/value, base_cr) so reference call sites
translate one-for-one, including ``cd_values`` packing and the CDO
``--filter`` string.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .. import api
from ..codec.config import MODE_NAMES as _MODE_NAMES
from ..codec.config import EBCCConfig, ResidualMode

_ATTR = "ebcc_tpu"


@dataclasses.dataclass
class EBCCFilterParams:
    """Construction-parity equivalent of ``EBCC_Filter``
    (filter_wrapper.py:19-82).

    ``residual_opt`` is a ``(mode_name, value)`` pair, e.g.
    ``("relative_error", 0.009)`` — the same surface as the reference's
    ``residual_opt`` tuples.  ``data_dim`` controls the chunk rank, like
    the reference's ``data_dim`` (filter_wrapper.py:32).
    """

    base_cr: float = 100.0
    height: int = 721
    width: int = 1440
    residual_opt: tuple = ("max_error_target", 1e-2)
    data_dim: int = 2

    def _mode_value(self):
        name, value = self.residual_opt
        name = {"max_error_target": "max_error",
                "relative_error_target": "relative_error",
                "quantile_target": "sparsification_factor",
                "fixed_sparsification": "sparsification_factor",
                }.get(name, name)
        return _MODE_NAMES[name], float(value)

    def to_config(self) -> EBCCConfig:
        mode, value = self._mode_value()
        kw = dict(mode=mode, base_cr=float(self.base_cr))
        if mode in (ResidualMode.MAX_ERROR, ResidualMode.RELATIVE_ERROR):
            kw["error"] = value
        elif mode == ResidualMode.SPARSIFICATION_FACTOR:
            kw["residual_cr"] = value
        elif mode == ResidualMode.POINTWISE_MAX_ERROR:
            kw["pointwise_max_error_ratio"] = value
        return EBCCConfig(**kw)

    @property
    def filter_id(self) -> int:
        mode, _ = self._mode_value()
        return (FILTER_ID_POINTWISE
                if mode == ResidualMode.POINTWISE_MAX_ERROR else FILTER_ID)

    def cd_values(self) -> tuple:
        """HDF5 ``cd_values`` for the filter plugins: (height, width,
        base_cr as f32 bits, mode, parameter as f32 bits) — the reference's
        packing (filter_wrapper.py:11-58)."""
        import struct

        def f2u(v):
            return struct.unpack("<I", struct.pack("<f", float(v)))[0]

        mode, value = self._mode_value()
        return (int(self.height), int(self.width), f2u(self.base_cr),
                int(mode), f2u(value))

    def chunks(self) -> tuple:
        mode, _ = self._mode_value()
        if mode == ResidualMode.POINTWISE_MAX_ERROR:
            return (*[1] * (max(self.data_dim, 3) - 3), 2,
                    self.height, self.width)  # filter_wrapper.py:52
        return (*[1] * (self.data_dim - 2), self.height, self.width)

    def hdf5_kwargs(self) -> dict:
        """``h5py.Group.create_dataset`` kwargs, like the reference's
        ``EBCC_Filter`` Mapping (filter_wrapper.py:66-72).  Requires the
        plugin on the search path (``register_plugin_path()``)."""
        return {
            "dtype": "float32",
            "chunks": self.chunks(),
            "compression": self.filter_id,
            "compression_opts": self.cd_values(),
            "allow_unknown_filter": True,
        }

    def cdo_filter_string(self) -> str:
        """The CDO ``--filter`` argument (filter_wrapper.py:133-140):
        ``cdo --filter <this> copy in.nc out.nc``."""
        return ",".join(str(v) for v in (self.filter_id, *self.cd_values()))


def write_dataset(group, name: str, data, config: EBCCConfig | None = None,
                  error_bound=None, params: EBCCFilterParams | None = None,
                  *, device="cuda"):
    """Compress ``data`` and store it as ``group[name]`` (opaque bytes)."""
    if config is None:
        config = (params or EBCCFilterParams(
            height=data.shape[-2], width=data.shape[-1])).to_config()
    data = np.asarray(data, np.float32)
    blob = api.compress(data, config, error_bound=error_bound,
                        device=device)
    dset = group.create_dataset(
        name, data=np.frombuffer(blob, np.uint8), dtype=np.uint8)
    dset.attrs[_ATTR] = json.dumps({
        "version": 1,
        "shape": list(data.shape),
        "mode": int(config.mode),
        "config": {k: (v if not isinstance(v, ResidualMode) else int(v))
                   for k, v in dataclasses.asdict(config).items()},
    })
    return dset


def read_dataset(dset, *, device="cuda") -> np.ndarray:
    """Decompress a dataset written by :func:`write_dataset`."""
    meta = json.loads(dset.attrs[_ATTR])
    cfg = meta["config"]
    cfg["mode"] = ResidualMode(cfg["mode"])
    config = EBCCConfig(**cfg)
    blob = bytes(np.asarray(dset[:], np.uint8))
    out = api.decompress(blob, config, device=device)
    return out.reshape(meta["shape"])


def is_ebcc_dataset(dset) -> bool:
    return _ATTR in getattr(dset, "attrs", {})


# ---------------------------------------------------------------------------
# True HDF5-filter integration (reference parity: filters 308/310)
# ---------------------------------------------------------------------------

FILTER_ID = 33076            # EBCC-TPU standard filter (ref 308)
FILTER_ID_POINTWISE = 33077  # pointwise [data ‖ error_bound] filter (ref 310)
FILTER_ID_EMULATE = 33078    # compress+decompress-in-forward filter (ref 309)

def _plugin_dir() -> str:
    """The port's build of the three filter plugins (built on first use
    from the ``native/`` sources into ``ebcc_tpu_torch/build/``)."""
    from ..runtime.native import build_plugins
    return build_plugins()


def register_plugin_path(path: str | None = None):
    """Make libh5z_ebcc_tpu.so discoverable by libhdf5 (reader side).

    The reference sets HDF5_PLUGIN_PATH (filter_wrapper.py:3); h5py also
    accepts runtime registration via h5py.h5pl.
    """
    import h5py
    p = (path or _plugin_dir()).encode()
    try:
        existing = [h5py.h5pl.get(i) for i in range(h5py.h5pl.size())]
    except Exception:
        existing = []
    if p not in existing:
        h5py.h5pl.prepend(p)


def write_filtered_dataset(group, name: str, data,
                           config: EBCCConfig | None = None,
                           error_bound=None, *, device="cuda"):
    """Create a REAL filtered float dataset (one frame per chunk),
    compressing through the batched device path on ``device``.

    Readers that load the plugin (``register_plugin_path()`` or
    HDF5_PLUGIN_PATH) see a plain float32 dataset — the reference's
    integration model (h5z_j2k.c).  The pre-compressed frame containers
    are stored with H5Dwrite_chunk, skipping the (CPU-side) filter
    pipeline; this is the fast path when a device is available.

    Plain ``dset[...] = data`` writes also compress — through the plugin's
    own CPU encoder (native/ebcc_cpu_encoder.cc) — when the dataset was
    created with the filter's ``cd_values`` (see
    :func:`create_filtered_dataset` / ``EBCCFilterParams.hdf5_kwargs``);
    the two paths emit byte-identical chunks.
    """
    import h5py
    if config is None:
        config = EBCCFilterParams(height=data.shape[-2],
                                  width=data.shape[-1]).to_config()
    data = np.asarray(data, np.float32)
    h, w = data.shape[-2], data.shape[-1]
    frames = data.reshape(-1, h, w)
    blob = api.compress(frames, config, error_bound=error_bound,
                        device=device)
    from ..codec import container as _c
    frame_bytes = _c.unpack_blob(blob)
    dset = group.create_dataset(
        name, shape=frames.shape, dtype=np.float32, chunks=(1, h, w),
        compression=FILTER_ID, allow_unknown_filter=True)
    for i, fb in enumerate(frame_bytes):
        dset.id.write_direct_chunk((i, 0, 0), fb, filter_mask=0)
    dset.attrs[_ATTR] = json.dumps({"version": 2, "filter": FILTER_ID,
                                    "shape": list(data.shape)})
    return dset


def create_filtered_dataset(group, name: str, shape,
                            params: EBCCFilterParams | None = None,
                            **overrides):
    """Create an (empty) dataset wired to the EBCC-TPU filter so that
    plain h5py writes (``dset[...] = data``) compress through the plugin's
    CPU encoder — the reference's write model (h5z_j2k.c:124-136).

    ``params`` defaults to an ``EBCCFilterParams`` sized from ``shape``.
    Requires the write-capable plugin on the plugin path
    (``register_plugin_path()``).
    """
    if params is None:
        params = EBCCFilterParams(height=shape[-2], width=shape[-1],
                                  data_dim=len(shape))
    kw = params.hdf5_kwargs()
    kw.update(overrides)
    register_plugin_path()
    return group.create_dataset(name, shape=shape, **kw)
