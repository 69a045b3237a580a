"""CUDA graphs of the codec's device stages: one capture per static key,
then one replay per call.

The counterpart of ``jax.jit`` around each ``FrameCodec`` stage
(``ebcc_tpu/codec/pipeline.py``): JAX compiles a stage once per argument
shape and dispatches it as one program; here the stage's ~2700 kernel
launches are captured once into a :class:`torch.cuda.CUDAGraph` and each
later call is one graph launch.

* **The key** (:func:`stage_key`) is everything the captured work depends
  on other than the contents of a tensor: the stage and the shape, dtype
  and device of every tensor argument.  A stage takes no Python scalar:
  the codec passes its base quantiles and bit budgets as device tensors
  that each call copies in, as JAX traces them, so one graph serves every
  value.
* **When**: a key's first call runs the stage eagerly (that run is the
  capture's warm-up: kernel libraries loaded, shared-memory attributes
  set) and returns its outputs; its second call captures the stage, and
  every later call replays it.  A key used once costs what the eager
  stage costs.
* **Inputs**: each call copies its tensors into the graph's static input
  buffers (allocated outside the graph's pool), then replays.
* **Outputs**: a replay overwrites the graph's outputs, and the api keeps
  up to ``prefetch_batches + 1`` batches in flight, so every replay's
  outputs are cloned right after it: each call returns fresh tensors, as
  a jitted call returns fresh arrays.
* **One stream and one lock**: every call of a device (eager first call,
  capture, replay) runs on the cache's stream of that device, after the
  caller's stream and before the caller's next work, and holds the
  cache's lock from the lookup to the clones.  So the static buffers of a
  graph and the pool its graphs share (below) are used in one order even
  when threads call one key at once (a numcodecs filter under dask), and
  one thread's copy-in cannot land between another's copy-in and replay.
  The lock covers enqueueing only, a few milliseconds a replay.
* **Memory**: the graphs of one device share one memory pool.  What a
  capture frees (its intermediates) a later capture may reuse, so one
  graph's replay may overwrite another's outputs; that is safe because
  every replay's outputs are cloned before the next replay on the same
  stream.  :class:`GraphCache` keeps at most ``maxsize`` graphs alive,
  least recently used first out.
* **Capture rules**: a stage makes no host read and no pageable
  host-to-device copy; the capture's error mode is ``thread_local``, so
  another thread's allocations and copies while it records do not void
  it.  A failed capture or replay raises: there is no eager retry on a
  CUDA tensor.
* **Launch counts**: a capture calls each kernel's C entry without running
  it, so its counts are put back and recorded; each replay adds them
  (:func:`..runtime.cuda.count_launches`).
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import OrderedDict

import torch

from ..utils import profiling
from . import cuda

# graphs alive in the process, over every codec and device
MAX_GRAPHS = 16
# keys whose first (eager) call is remembered, so their second captures
MAX_SEEN = 256

_owners = itertools.count()


def new_owner(obj) -> int:
    """A key prefix for ``obj``'s graphs, never reused; its graphs leave
    :data:`CACHE` when ``obj`` is collected."""
    token = next(_owners)
    weakref.finalize(obj, CACHE.drop_owner, token).atexit = False
    return token


def stage_key(stage: str, args: tuple) -> tuple:
    """The capture key of ``stage`` called with ``args``: each tensor's
    shape, dtype and device (None stands for an absent tensor).  Any other
    argument raises: a capture would bake its value into the graph."""
    def sig(a):
        if torch.is_tensor(a):
            return (tuple(a.shape), a.dtype, a.device)
        if a is None:
            return None
        raise TypeError(f"a graphed stage takes no {type(a).__name__}: "
                        "pass it as a tensor")
    return (stage, tuple(sig(a) for a in args))


def flatten(obj):
    """(the structure of ``obj``, its distinct tensors): tensors inside
    tuples, lists and named tuples; a tensor shared by several fields is
    one leaf, and stays shared in :func:`unflatten`."""
    leaves, index = [], {}

    def walk(x):
        if torch.is_tensor(x):
            if id(x) not in index:
                index[id(x)] = len(leaves)
                leaves.append(x)
            return index[id(x)]
        if isinstance(x, (tuple, list)):
            return (type(x), [walk(v) for v in x])
        raise TypeError(f"a graphed stage cannot return {type(x).__name__}")

    return walk(obj), leaves


def unflatten(spec, leaves: list):
    if isinstance(spec, int):
        return leaves[spec]
    typ, kids = spec
    vals = [unflatten(k, leaves) for k in kids]
    return typ(*vals) if hasattr(typ, "_fields") else typ(vals)


class StageGraph:
    """One captured stage: ``graph`` (its ``replay()`` runs the captured
    work on ``inputs``' buffers into ``outputs``), the output structure
    ``spec``, the kernel launches the capture recorded, and what the
    capture cost: ``capture_s`` seconds (capture and instantiation),
    ``reserved_bytes`` (the device memory the capture added to the pool:
    what it could not take from blocks earlier captures freed) and
    ``held_bytes`` (the static inputs and outputs that stay allocated)."""

    def __init__(self, graph, inputs, outputs, spec, launches, capture_s=0.0,
                 reserved_bytes=0, held_bytes=0, device=None):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.spec, self.launches, self.device = spec, launches, device
        self.capture_s = capture_s
        self.reserved_bytes, self.held_bytes = reserved_bytes, held_bytes
        self.replays = 0

    def replay(self, args):
        """Copy ``args``' tensors into the static inputs, replay, and
        return clones of the outputs in the stage's structure."""
        for buf, a in zip(self.inputs, args):
            if torch.is_tensor(buf):
                buf.copy_(a)
        self.graph.replay()
        cuda.add_launches(self.launches)
        self.replays += 1
        return unflatten(self.spec, [t.clone() for t in self.outputs])


def _static(a):
    return torch.empty(a.shape, dtype=a.dtype, device=a.device).copy_(a) \
        if torch.is_tensor(a) else a


def capture(fn, args, device: torch.device, pool) -> StageGraph:
    """Capture ``fn(*args)`` on the current stream into a CUDA graph in
    ``pool``, on static copies of ``args``.  The key's eager first call,
    on the same stream, was the warm-up.

    The capture is begun and ended by hand: ``torch.cuda.graph`` would
    also empty the device's and the pinned host memory caches before each
    capture, so the batches after it would allocate both again."""
    t0 = time.perf_counter()
    inputs = [_static(a) for a in args]
    torch.cuda.synchronize(device)
    reserved0 = torch.cuda.memory_reserved(device)
    allocated0 = torch.cuda.memory_allocated(device)
    graph = torch.cuda.CUDAGraph()

    def record():
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            return fn(*inputs)
        finally:
            graph.capture_end()

    out, launches = cuda.count_launches(record)
    spec, leaves = flatten(out)
    del out
    torch.cuda.synchronize(device)
    return StageGraph(graph, inputs, leaves, spec, launches,
                      time.perf_counter() - t0,
                      torch.cuda.memory_reserved(device) - reserved0,
                      torch.cuda.memory_allocated(device) - allocated0 +
                      sum(t.numel() * t.element_size() for t in inputs
                          if torch.is_tensor(t)), device)


class GraphCache:
    """The captured stages of the process, keyed by (owner, stage key):
    at most ``maxsize`` graphs, least recently used first out; the graphs
    of one device share one memory pool and one stream.

    A graph leaves when it is the least recently used one past
    ``maxsize``, or at the next :meth:`run` after its owner was collected
    (never from inside a capture, where a collection may happen).  Its
    memory goes back to the pool; a replay of it still in flight finishes
    first, as the pool's next user runs after it on the same stream."""

    def __init__(self, maxsize: int = MAX_GRAPHS):
        self.maxsize = maxsize
        self.graphs: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()
        self._dead: set = set()
        self._pools: dict = {}
        self._streams: dict = {}
        self._lock = threading.RLock()

    def _capture(self, fn, args, device) -> StageGraph:
        if not any(e.device == device for e in self.graphs.values()):
            # the allocator releases a pool once its last graph is gone
            # and takes no capture into it after that: start another
            self._pools[device] = torch.cuda.graph_pool_handle()
        return capture(fn, args, device, self._pools[device])

    def _kind(self, key) -> str:
        """The span name of the key's next call: its first runs eagerly,
        its second captures (and replays), every later one replays."""
        if key in self.graphs:
            return "graph.replay"
        return "graph.capture" if key in self._seen else "graph.eager"

    def _call(self, kind, key, fn, args, device):
        """One call of the key as :meth:`_kind` said."""
        if kind == "graph.eager":
            self._seen[key] = None
            while len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
            return fn(*args)
        if kind == "graph.capture":
            entry = self._capture(fn, args, device)
            self.graphs[key] = entry
            while len(self.graphs) > self.maxsize:
                self.graphs.popitem(last=False)
        else:
            entry = self.graphs[key]
            self.graphs.move_to_end(key)
        return entry.replay(args)

    def run(self, owner: int, stage: str, fn, args, device: torch.device):
        """``fn(*args)``: eager at its key's first call, then a replay of
        the key's graph (captured at the second call).  Spans: the wait for
        the lock (``graph.lock_wait``), then the call with the lock held
        (``graph.eager``, ``graph.capture`` or ``graph.replay``)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (owner, stage_key(stage, args))
        with profiling.span("graph.lock_wait"):
            self._lock.acquire()
        try:
            while self._dead:
                dead = self._dead.pop()
                for k in [k for k in self.graphs if k[0] == dead]:
                    del self.graphs[k]
                for k in [k for k in self._seen if k[0] == dead]:
                    del self._seen[k]
            kind = self._kind(key)
            with profiling.span(kind, stage=stage):
                if device.type != "cuda":
                    return self._call(kind, key, fn, args, device)
                return self._run_on_stream(kind, key, fn, args, device)
        finally:
            self._lock.release()

    def _run_on_stream(self, kind, key, fn, args, device):
        """:meth:`_call` on the cache's stream of ``device``, after the
        caller's stream and before its next work."""
        with torch.cuda.device(device):
            caller = torch.cuda.current_stream(device)
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device)
            stream.wait_stream(caller)
            for a in args:
                if torch.is_tensor(a):
                    # read on the stream: the caller may free it now
                    a.record_stream(stream)
            with torch.cuda.stream(stream):
                out = self._call(kind, key, fn, args, device)
            caller.wait_stream(stream)
            for t in flatten(out)[1]:
                # made on the stream, used and freed on the caller's
                t.record_stream(caller)
            return out

    def drop_owner(self, owner: int) -> None:
        """Release ``owner``'s graphs at the next :meth:`run`."""
        self._dead.add(owner)

    def entries(self, owner: int) -> dict:
        """{stage key: :class:`StageGraph`} of ``owner``'s live graphs."""
        with self._lock:
            return {k[1]: v for k, v in self.graphs.items()
                    if k[0] == owner}


CACHE = GraphCache()
