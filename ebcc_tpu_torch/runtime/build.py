"""Builds of the port's native code, cached in ``ebcc_tpu_torch/build/``.

Every build output is keyed on a hash of its sources and flags, built into
a temporary directory and moved into place with one rename, so concurrent
processes never load a half-written library and a source edit never loads
a stale one.  A lock file per output name in the build directory
(``fcntl.flock``) makes concurrent first uses build once.  Nothing is
written outside ``ebcc_tpu_torch/build/``.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")


def source_key(paths, flags) -> str:
    """Short content hash of the source files (and headers) plus flags."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def run(cmds: list[list[str]]) -> None:
    """Run build commands in parallel; raise with their output on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))


@contextlib.contextmanager
def _locked(name: str):
    """Hold the build directory's lock of ``name`` (blocks while another
    process builds it)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def cached_library(name: str, key: str, build_fn) -> str:
    """Path of ``build/<name>-<key>/lib<name>.so``, calling
    ``build_fn(tmpdir) -> built .so path`` first when it does not exist."""
    out_dir = os.path.join(BUILD_DIR, f"{name}-{key}")
    out = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(out):
        return out
    with _locked(name):
        if not os.path.exists(out):
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                built = build_fn(tmp)
                os.makedirs(out_dir, exist_ok=True)
                os.replace(built, out)
    return out


def cached_dir(name: str, key: str, build_fn) -> str:
    """Path of the directory ``build/<name>-<key>``, calling
    ``build_fn(tmpdir)`` to fill a temporary directory that is then renamed
    into place, when it does not exist."""
    out = os.path.join(BUILD_DIR, f"{name}-{key}")
    if os.path.isdir(out):
        return out
    with _locked(name):
        if not os.path.isdir(out):
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                filled = os.path.join(tmp, name)
                os.makedirs(filled)
                build_fn(filled)
                os.replace(filled, out)
    return out
