"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one C entry of a CUDA C++ source ``csrc/<library>.cu`` with a
plain C interface, plus the ``csrc/*.cuh`` headers it includes; several
kernels may share one library.  On first use the library is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ebcc_tpu_torch/build/`` (keyed on a hash of the source, every header it
includes, found from its ``#include "..."`` lines, and the flags) and loaded
with ctypes.  Every C entry launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises
when that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build

# -fmad=false: nvcc contracts no multiply-add on its own, so the only fused
# multiply-adds are the explicit __fmaf_rn calls at the native codec's fma
# sites (never build these sources with --use_fast_math)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def included_sources(path: str) -> list[str]:
    """``path`` and every file it includes with ``#include "..."``,
    transitively (paths relative to the including file)."""
    out, todo = [], [path]
    while todo:
        p = todo.pop()
        if p in out:
            continue
        out.append(p)
        with open(p) as f:
            todo += [os.path.join(os.path.dirname(p), inc) for inc in
                     re.findall(r'^#include "([^"]+)"', f.read(), re.M)]
    return out


class Kernel:
    """One C entry of a CUDA kernel library built from ``csrc/<library>.cu``
    (``library`` defaults to ``name``): its lazily built library and its
    launch count.

    ``sources``: the ``.cu`` file first, then every header it includes; the
    build is keyed on all of them.  ``launches`` counts calls of
    :meth:`launch`, the only place the wrapper starts the kernel, and the
    kernel's launches inside every CUDA graph replay
    (:func:`count_launches`, :func:`add_launches`); a caller resets it to
    0 to count one run.
    """

    # every kernel of the process, for the graph replays' launch counts
    _all: weakref.WeakSet = weakref.WeakSet()

    def __init__(self, name: str, entry: str, argtypes: list,
                 library: str | None = None):
        self.name, self.entry, self.argtypes = name, entry, argtypes
        self.library = library or name
        self.source = os.path.join(build.CSRC_DIR, f"{self.library}.cu")
        self.launches = 0
        self.build_seconds = None
        self._lib = None
        Kernel._all.add(self)

    @property
    def sources(self) -> list[str]:
        return included_sources(self.source)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            t0 = time.perf_counter()
            key = build.source_key(self.sources, NVCC_FLAGS)

            def compile_into(tmp):
                so = os.path.join(tmp, f"lib{self.library}.so")
                build.run([[nvcc(), *NVCC_FLAGS, "-o", so, self.source]])
                return so

            lib = ctypes.CDLL(build.cached_library(self.library, key,
                                                   compile_into))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.ebcc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ebcc_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
            self.build_seconds = time.perf_counter() - t0
        return self._lib

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry on ``device``'s current stream (the stream is
        appended as the last argument)."""
        lib = self.lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, self.entry)(device.index or 0, *args, stream)
        self.launches += 1
        if rc != 0:
            msg = lib.ebcc_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} ({rc})")


def count_launches(fn):
    """Run ``fn()`` while a CUDA graph captures it and return (its result,
    {kernel: launches it recorded}).  A capture calls the C entries but
    runs nothing on the device, so every kernel's count is put back as it
    was; :func:`add_launches` adds the recorded launches at each replay."""
    before = {k: k.launches for k in Kernel._all}
    try:
        out = fn()
    finally:
        recorded = {k: k.launches - before.get(k, 0) for k in Kernel._all}
        for k in recorded:
            k.launches = before.get(k, 0)
    return out, {k: n for k, n in recorded.items() if n}


def add_launches(recorded: dict) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``recorded`` ({kernel: launches}, from :func:`count_launches`)."""
    for k, n in recorded.items():
        k.launches += n


def build_all(kernels) -> None:
    """Build (or load from the cache) every kernel's library, one ``nvcc``
    per library, all started together; then load the other entries of each
    library from the cache."""
    first = {}
    for k in kernels:
        first.setdefault(k.library, k)
    with ThreadPoolExecutor(max_workers=max(1, len(first))) as ex:
        list(ex.map(Kernel.lib, first.values()))
    for k in kernels:
        k.lib()


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda_tensor(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
