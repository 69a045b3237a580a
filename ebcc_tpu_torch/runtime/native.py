"""ctypes loader for the shared native host runtime (``native/``).

The port uses the same C++ host coder, zstd stage and CPU encoder/decoder
as the JAX package, unchanged.  On first use this module builds them from
the ``native/`` sources with the Makefile's flags into
``ebcc_tpu_torch/build/`` (:mod:`.build`: keyed on the sources and flags,
built in a temporary directory and renamed into place, under a lock), and
never writes into ``native/``: the JAX package's own ``make -C native``
runs there.  The system ``zstd.h`` is used where the compiler finds one,
else the declarations of ``csrc/compat/zstd.h`` (hosts that ship only the
runtime ``libzstd.so.1``).  :func:`build_plugins` builds the three HDF5
filter plugins the same way.

There is no pure-Python fallback: if the build fails, :func:`lib` raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from . import build

NATIVE_DIR = os.path.join(build.REPO_DIR, "native")
_SOURCES = ("ebcc_host.cc", "ebcc_coder.cc", "ebcc_coder_fast.cc",
            "ebcc_cpu_decoder.cc", "ebcc_cpu_encoder.cc")
# the codec objects the HDF5 plugins link (native/Makefile's codec_objs)
_CODEC_SOURCES = ("ebcc_cpu_decoder.cc", "ebcc_cpu_encoder.cc",
                  "ebcc_coder.cc", "ebcc_coder_fast.cc")
# one plugin library per filter id: (name, defines) of native/Makefile
_PLUGINS = (("libh5z_ebcc_tpu.so", []),
            ("libh5z_ebcc_tpu_pw.so", ["-DEBCC_PLUGIN_POINTWISE"]),
            ("libh5z_ebcc_tpu_emu.so", ["-DEBCC_PLUGIN_EMULATE"]))
# native/Makefile's CXXFLAGS (value-safe: -ffp-contract=off, explicit fma)
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off",
             "-march=native"]
_LDFLAGS = ["-shared", "-l:libzstd.so.1", "-lpthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SZ = ctypes.c_size_t

# argtypes/restype of every entry point the port calls
_SIGNATURES = {
    "ebcc_zstd_compress_batch": ([_P, _P, _I, _I, _P, _SZ, _P], None),
    "ebcc_zstd_decompress_batch": ([_P, _P, _I, _P, _SZ, _P], None),
    "ebcc_zstd_bound": ([_SZ], _SZ),
    "ebcc_scale_u16_batch": ([_P, _I, _I, _I, _P, _P, _P, _P], None),
    "ebcc_coder_encode_batch": ([_P, _I, _I, _I, _I, _I, _I, _P, _P, _I64],
                                None),
    "ebcc_coder_decode_batch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _P], None),
    "ebcc_coder_decode_batch_u16": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _I, _P, _P, _P], None),
    "ebcc_cpu_encode_frame": ([_P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P, _I64], _I64),
    "ebcc_cpu_decode_frame": ([_P, _I64, _I, _F, _F, _F, _I, _I, _I, _I, _I,
                               _I, ctypes.c_uint32, _I, _P, _I64, _I, _F, _F,
                               _F, _I, _I, _I, ctypes.c_uint32, _P], _I),
    "ebcc_cpu_debug_base_coef": ([_P, _I, _I, _I, _P], _F),
}


@functools.cache
def _zstd_header() -> list[str]:
    """The zstd header to build against: [] where the compiler finds the
    system ``zstd.h``, else ``csrc/compat/zstd.h``."""
    r = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                       input="#include <zstd.h>\n", capture_output=True,
                       text=True)
    return [] if r.returncode == 0 else [
        os.path.join(build.CSRC_DIR, "compat", "zstd.h")]


def _compile(srcs, tmp):
    """Compile ``native/`` sources into ``tmp``, one g++ each, in
    parallel; ``srcs`` are (file name, defines, object name) triples.
    Returns the object paths."""
    hdrs = _zstd_header()
    flags = _CXXFLAGS + [f for h in hdrs for f in ("-I", os.path.dirname(h))]
    objs = [os.path.join(tmp, f"{tag}.o") for _, _, tag in srcs]
    # the word-parallel coder needs BMI2/POPCNT codegen; it is gated at
    # run time, so only that file gets the flags (as in the Makefile)
    build.run([["g++", *flags, *defs,
                *(["-mbmi2", "-mpopcnt"]
                  if s == "ebcc_coder_fast.cc" else []),
                "-c", os.path.join(NATIVE_DIR, s), "-o", o]
               for (s, defs, _), o in zip(srcs, objs)])
    return objs


def _key(names, extra=()) -> str:
    return build.source_key(
        [os.path.join(NATIVE_DIR, s) for s in names] + _zstd_header(),
        _CXXFLAGS + _LDFLAGS + list(extra))


def build_library() -> str:
    """Build (or find up to date) the host library; returns its path."""
    def compile_into(tmp):
        objs = _compile([(s, [], s) for s in _SOURCES], tmp)
        so = os.path.join(tmp, "libebcc_host.so")
        build.run([["g++", *objs, "-o", so, *_LDFLAGS]])
        return so

    return build.cached_library("ebcc_host", _key(_SOURCES), compile_into)


def build_plugins() -> str:
    """Build (or find up to date) the three HDF5 filter plugins (ids
    33076-33078) into one directory; returns it (the plugin path)."""
    names = _CODEC_SOURCES + ("h5z_ebcc_tpu.cc",)

    def compile_into(out):
        tmp = os.path.join(out, ".obj")
        os.makedirs(tmp)
        codec = _compile([(s, [], s) for s in _CODEC_SOURCES], tmp)
        shims = _compile([("h5z_ebcc_tpu.cc", defs, so)
                          for so, defs in _PLUGINS], tmp)
        build.run([["g++", shim, *codec, "-o", os.path.join(out, so),
                    *_LDFLAGS] for shim, (so, _) in zip(shims, _PLUGINS)])
        for o in codec + shims:
            os.remove(o)
        os.rmdir(tmp)

    return build.cached_dir("h5z_plugins",
                            _key(names, [f for _, d in _PLUGINS for f in d]),
                            compile_into)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    handle = ctypes.CDLL(build_library())
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = args
        fn.restype = res
    return handle


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _ptr_array(bufs):
    arr = (ctypes.c_char_p * len(bufs))(*bufs)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def zstd_compress_batch(bufs: list[bytes], level: int) -> list[bytes]:
    """Compress a list of byte strings in parallel native threads."""
    n = len(bufs)
    if n == 0:
        return []
    L = lib()
    cap = int(L.ebcc_zstd_bound(max(len(b) for b in bufs)))
    dst = np.empty(n * cap, np.uint8)
    sizes_in = np.asarray([len(b) for b in bufs], np.uintp)
    sizes_out = np.zeros(n, np.uintp)
    ptrs, _keep = _ptr_array(bufs)
    L.ebcc_zstd_compress_batch(ptrs, _ptr(sizes_in), n, level, _ptr(dst),
                               cap, _ptr(sizes_out))
    return _slices(dst, cap, sizes_out, "compression")


def zstd_decompress_batch(bufs: list[bytes], max_sizes: list[int]
                          ) -> list[bytes]:
    n = len(bufs)
    if n == 0:
        return []
    cap = max(1, max(int(m) for m in max_sizes))
    dst = np.empty(n * cap, np.uint8)
    sizes_in = np.asarray([len(b) for b in bufs], np.uintp)
    sizes_out = np.zeros(n, np.uintp)
    ptrs, _keep = _ptr_array(bufs)
    lib().ebcc_zstd_decompress_batch(ptrs, _ptr(sizes_in), n, _ptr(dst), cap,
                                     _ptr(sizes_out))
    return _slices(dst, cap, sizes_out, "decompression")


def _slices(dst, cap, sizes, what):
    err = int(np.iinfo(np.uintp).max)
    out = []
    for i, sz in enumerate(int(s) for s in sizes):
        if sz == err:
            raise RuntimeError(f"native zstd {what} failed")
        out.append(dst[i * cap: i * cap + sz].tobytes())
    return out


def scale_u16_batch(frames: np.ndarray):
    """Host u16 quantisation (native ebcc_scale_u16_batch): returns
    ``(u, mn, mx, maxq)`` — the uint16 planes, per-frame ranges and the
    per-frame quantisation-error bounds the error targets are tightened
    by.  The native CPU encoder uses the same code, which keeps its
    containers byte-identical to the device path's."""
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w = frames.shape
    u = np.empty((n, h, w), np.uint16)
    mn = np.empty(n, np.float32)
    mx = np.empty(n, np.float32)
    maxq = np.empty(n, np.float32)
    lib().ebcc_scale_u16_batch(_ptr(frames), n, h, w, _ptr(u), _ptr(mn),
                               _ptr(mx), _ptr(maxq))
    return u, mn, mx, maxq


def _arena(trunc_bits, n):
    """(int64 truncations, the zeroed uint8 arena [n, cap_bytes])."""
    trunc = np.ascontiguousarray(trunc_bits, np.int64)
    cap_bytes = max(8, (int(trunc.max(initial=0)) + 7) // 8)
    return trunc, np.zeros((n, cap_bytes), np.uint8)


def coder_encode_batch(coef: np.ndarray, trunc_bits: np.ndarray,
                       group_levels: int, nplanes: int, nchunks: int
                       ) -> np.ndarray:
    """Native bitplane encode of int32 coefficient planes [n, h, w].
    Returns a uint8 arena [n, cap_bytes]; frame i's stream is
    ``arena[i, : (bits + 7) // 8]`` for any prefix ``bits <= trunc_bits[i]``
    (embedded stream)."""
    coef = np.ascontiguousarray(coef, np.int32)
    n, h, w = coef.shape
    trunc, out = _arena(trunc_bits, n)
    lib().ebcc_coder_encode_batch(_ptr(coef), n, h, w, group_levels, nplanes,
                                  nchunks, _ptr(trunc), _ptr(out),
                                  out.shape[1])
    return out


def _decode_args(streams, nbits, max_step, mask_plane, keep_mask):
    n = len(streams)
    blob = b"".join(streams)
    sizes = np.asarray([len(s) for s in streams], np.int64)
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    # clamp declared bits to the bytes actually present
    nbits = np.minimum(np.ascontiguousarray(nbits, np.int64), sizes * 8)
    max_step = np.ascontiguousarray(max_step, np.int32)
    mp = np.ascontiguousarray(mask_plane, np.int32)
    km = np.ascontiguousarray(keep_mask, np.uint32)
    keep = (blob, offsets, nbits, max_step, mp, km)
    ptrs = (ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p),
            _ptr(offsets), _ptr(nbits), _ptr(max_step), _ptr(mp), _ptr(km))
    return ptrs, keep


def coder_decode_batch(streams: list[bytes], nbits, max_step, h: int, w: int,
                       group_levels: int, nplanes: int, nchunks: int,
                       mask_plane, keep_mask) -> np.ndarray:
    """Native structural decode -> float32 midpoint coefficients [n, h, w].
    ``mask_plane[i] < 0`` disables the format-v4 chunk mask of frame i."""
    ptrs, _keep = _decode_args(streams, nbits, max_step, mask_plane,
                               keep_mask)
    out = np.empty((len(streams), h, w), np.float32)
    lib().ebcc_coder_decode_batch(*ptrs, len(streams), h, w, group_levels,
                                  nplanes, nchunks, _ptr(out))
    return out


def coder_decode_batch_u16(streams: list[bytes], nbits, max_step, h: int,
                           w: int, group_levels: int, nplanes: int,
                           nchunks: int, mask_plane, keep_mask):
    """Native structural decode -> packed u16 state (sign<<15 | last_off<<14
    | mag>>b_end) + per-frame b_end.  Returns (packed, bend, ok); frames
    with ok == 0 need :func:`coder_decode_batch`."""
    ptrs, _keep = _decode_args(streams, nbits, max_step, mask_plane,
                               keep_mask)
    n = len(streams)
    out = np.empty((n, h, w), np.uint16)
    bend = np.zeros(n, np.int32)
    ok = np.zeros(n, np.int32)
    lib().ebcc_coder_decode_batch_u16(*ptrs, n, h, w, group_levels, nplanes,
                                      nchunks, _ptr(out), _ptr(bend),
                                      _ptr(ok))
    return out, bend, ok


def debug_base_coef(frame: np.ndarray, levels: int):
    """The native encoder's quantised base coefficients of one [h, w]
    frame (u16 scale -> pad -> DC -> forward DWT -> weights -> trunc).
    Returns (int32 [hp, wp], dc)."""
    from ..ops.frame import padded_size

    frame = np.ascontiguousarray(frame, np.float32)
    h, w = frame.shape
    out = np.empty((padded_size(h, levels), padded_size(w, levels)),
                   np.int32)
    dc = lib().ebcc_cpu_debug_base_coef(_ptr(frame), h, w, levels, _ptr(out))
    return out, dc
