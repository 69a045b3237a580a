"""The control and the planted faults of the correctness check.

Each is a ``wrap(config) -> (compress -> compress)`` that puts a broken
timed path in the program's place; a run through any of them must come
out with ``correct`` false.  ``control.py`` reads them on the chip at the
cell's own size, ``tests/test_portbench_faults.py`` on the CPU at a small
one.
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.reference import decode


def _pack_blob(frames: list) -> bytes:
    return (struct.pack("<4sI", decode.MAGIC_BLOB, len(frames))
            + struct.pack(f"<{len(frames)}Q", *map(len, frames))
            + b"".join(frames))


def bf16(config):
    """The control: the frames rounded to bfloat16, the nearest precision
    below the float32 the configuration states, before they are
    compressed (the shortcut of an upload in half the bytes)."""
    import torch

    def wrap(fn):
        def compress(stack, bound):
            low = torch.from_numpy(np.ascontiguousarray(stack)).to(
                torch.bfloat16).float().numpy()
            return fn(low, bound)
        return compress
    return wrap


def altered_point(config):
    """An answer altered where it is produced: every frame's middle point
    moved by three bounds before it is compressed."""
    g = config["guarantee"]

    def wrap(fn):
        def compress(stack, bound):
            x = np.array(stack)
            r, c = x.shape[1] // 2, x.shape[2] // 2
            step = (g["bound"] if g["kind"] == "abs"
                    else bound[:, r, c] * g["ratio"])
            x[:, r, c] += 3 * np.float32(1) * step
            return fn(x, bound)
        return compress
    return wrap


def half_batch(config):
    """Half of the stack left out: its first half is compressed and those
    answers stand in for the second half's."""
    def wrap(fn):
        def compress(stack, bound):
            half = len(stack) // 2
            frames = decode.split_blob(fn(
                stack[:half], None if bound is None else bound[:half]))
            return _pack_blob(frames + frames[:len(stack) - half])
        return compress
    return wrap


def missing_frame(config):
    """An answer that never comes: the last frame of every stack is left
    out of the container."""
    def wrap(fn):
        def compress(stack, bound):
            return fn(stack[:-1], None if bound is None else bound[:-1])
        return compress
    return wrap


def foreign_answer(config):
    """Answers crossed between requests, as threads that share a cache
    can cross them: one request in four, of any writer, gets the
    container that the last request before it got for another stack (the
    next one does where the stacks agree)."""
    import threading

    lock = threading.Lock()
    state = {"n": 0, "due": False, "last": (None, None)}

    def wrap(fn):
        def compress(stack, bound):
            blob = fn(stack, bound)
            key = stack.__array_interface__["data"][0]
            with lock:
                state["n"] += 1
                state["due"] |= state["n"] % 4 == 0
                (last_key, last), state["last"] = state["last"], (key, blob)
                if state["due"] and last is not None and last_key != key:
                    state["due"] = False
                    return last
            return blob
        return compress
    return wrap


CONTROL = {"bf16": bf16}
FAULTS = {"altered_point": altered_point, "half_batch": half_batch,
          "missing_frame": missing_frame, "foreign_answer": foreign_answer}
