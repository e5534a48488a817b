"""Build a CUDA source of ``csrc/`` with plain ``nvcc`` and load it with ``ctypes``.

Each source exposes ``extern "C"`` launchers that take raw pointers, sizes and a
stream and return a ``cudaError_t`` code; nothing includes PyTorch's headers, so a
build takes seconds. The shared library goes into ``csrc/_build/`` (gitignored),
named by a hash of the source, every header it includes with ``#include "..."``
(followed recursively) and the flags, and is built at first use: a fresh checkout
builds on its first call, a later call loads the cached file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "included_files", "expanded_source", "build_key", "build", "load"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "_build"
# sm_90a: Hopper with its architecture-specific instructions (wgmma, setmaxnreg).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built with the CUDA toolkit's "
        "nvcc (put it on PATH or set CUDA_HOME)."
    )


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
_INCLUDE_LINE = re.compile(r'^\s*#\s*include\s*"([^"]+)".*$', re.M)
_PRAGMA_ONCE = re.compile(r'^\s*#\s*pragma\s+once\s*$', re.M)


def included_files(src: Path) -> list:
    """``src`` and every file it includes with ``#include "..."``, recursively, each once.

    A quoted include is looked up beside the file that includes it (an absolute path
    as it is), as ``nvcc`` does first; system headers (``<...>``) are not followed.
    """
    seen, todo = [], [Path(src).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / name).resolve())
    return seen


def expanded_source(src: Path) -> str:
    """The text of ``src`` with each file it includes with ``#include "..."`` in the include's
    place, recursively, each file once (where the compiler's ``#pragma once`` keeps it): one
    self-contained translation unit, as a layout mirror reads its constants and a variant build
    edits it."""
    seen = set()

    def expand(path: Path) -> str:
        seen.add(path)

        def include(m: "re.Match") -> str:
            inner = (path.parent / m.group(1)).resolve()
            return "" if inner in seen else expand(inner)
        return _INCLUDE_LINE.sub(include, _PRAGMA_ONCE.sub("", path.read_text()))

    return expand(Path(src).resolve())


def build_key(src: Path) -> str:
    """Hash of the source, the headers it includes and the flags: the library's name."""
    h = hashlib.sha256()
    for path in included_files(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (or ``source``, when it is an absolute path) into a
    shared library unless it is already built.

    Returns the library's path. The compiler's ``-Xptxas -v`` report (registers,
    shared memory and spills per kernel) is kept beside it as ``<name>.ptxas.txt``.
    """
    src = CSRC_DIR / source
    key = build_key(src)
    lib = BUILD_DIR / f"{src.stem}-{key}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
    lib.with_name(f"{src.stem}-{key}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees no half-written file
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one handle per process."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(source)))
    return _loaded[source]
