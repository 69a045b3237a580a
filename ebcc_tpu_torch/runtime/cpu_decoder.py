"""Native CPU decoder (``ebcc_cpu_decode_frame``): container blob ->
float32 frames, no tensor framework involved.

Container parsing here, everything numeric in ``native/ebcc_cpu_decoder.cc``
(structural decode, subband weights, inverse lifting, reconstruction).  It
is the independent decoder the port's blobs are checked against.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..codec import container
from . import native as _native


def _validate_header(hdr) -> None:
    """Bound untrusted header fields before they size native allocations,
    shifts, or reads (same limits as native/h5z_ebcc_tpu.cc)."""
    if (hdr.h == 0 or hdr.w == 0 or hdr.h > 65536 or hdr.w > 65536 or
            hdr.h * hdr.w > (1 << 28) or
            hdr.base_levels > 8 or hdr.resid_levels > 8 or
            not 1 <= hdr.nchunks <= 64 or
            not 1 <= hdr.base_nplanes <= 30 or hdr.resid_nplanes > 30 or
            hdr.max_step_b > 30 or hdr.max_step_r > 30 or
            hdr.base_nbits > 64 * hdr.h * hdr.w or
            hdr.resid_nbits > 64 * hdr.h * hdr.w or
            not (hdr.base_mask_plane == container.MASK_NONE or
                 hdr.base_mask_plane < hdr.base_nplanes) or
            not (hdr.resid_mask_plane == container.MASK_NONE or
                 hdr.resid_mask_plane < hdr.resid_nplanes)):
        raise ValueError("corrupt EBCC-TPU frame header")


def _mask_plane(p: int) -> int:
    return -1 if p == container.MASK_NONE else p


def decompress(blob: bytes) -> np.ndarray:
    """Decode a container blob to [N, H, W] float32 on the CPU."""
    dec = _native.lib().ebcc_cpu_decode_frame
    metas = [container.unpack_frame(fb) for fb in container.unpack_blob(blob)]
    out: list = [None] * len(metas)

    # batched zstd stage: every compressed stream in one native call
    zjobs, zmax, zdst = [], [], []
    for i, (hdr, zblob, base_stream, _) in enumerate(metas):
        if hdr.flags & container.FLAG_CONST:
            if hdr.h == 0 or hdr.w == 0 or hdr.h * hdr.w > (1 << 28):
                raise ValueError("corrupt EBCC-TPU frame header")
            out[i] = np.full((hdr.h, hdr.w), hdr.mn, np.float32)
            continue
        _validate_header(hdr)
        if hdr.flags & container.FLAG_BASE_Z:
            zjobs.append(base_stream)
            zmax.append((hdr.base_nbits + 7) // 8)
            zdst.append((i, "base"))
        if hdr.flags & container.FLAG_RESID:
            zjobs.append(zblob)
            zmax.append((hdr.resid_nbits + 7) // 8)
            zdst.append((i, "resid"))
    streams = dict(zip(zdst, _native.zstd_decompress_batch(zjobs, zmax)))

    def run(i):
        hdr, _, base_stream, _ = metas[i]
        base = streams.get((i, "base"), base_stream)
        has_resid = bool(hdr.flags & container.FLAG_RESID)
        resid = streams.get((i, "resid"), b"")
        # header-declared bit counts must be backed by actual bytes — the
        # C decoder trusts them (out-of-bounds read otherwise)
        if len(base) * 8 < hdr.base_nbits or \
                (has_resid and len(resid) * 8 < hdr.resid_nbits):
            raise ValueError("truncated EBCC-TPU frame stream")
        frame = np.empty((hdr.h, hdr.w), np.float32)
        rc = dec(base, hdr.base_nbits, hdr.max_step_b, hdr.mn, hdr.mx,
                 hdr.dc_b, hdr.h, hdr.w, hdr.base_levels, hdr.base_nplanes,
                 hdr.nchunks, _mask_plane(hdr.base_mask_plane),
                 hdr.base_keep_mask, int(has_resid), resid, hdr.resid_nbits,
                 hdr.max_step_r, hdr.rmin, hdr.rmax, hdr.dc_r,
                 hdr.resid_levels, hdr.resid_nplanes,
                 _mask_plane(hdr.resid_mask_plane), hdr.resid_keep_mask,
                 frame.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"cpu decode failed: {rc}")
        out[i] = frame

    todo = [i for i in range(len(metas)) if out[i] is None]
    if todo:
        with ThreadPoolExecutor(
                max_workers=min(len(todo), os.cpu_count() or 1)) as ex:
            list(ex.map(run, todo))
    return np.stack(out)
