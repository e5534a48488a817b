"""ctypes bindings for the native (C++) trajectory prefetcher.

Counterpart of ``enf_pde_tpu/data/native_loader.py``. ``csrc/trajloader.cc`` runs a
small pthread worker pool that reads the cache's raw float32 trajectory files
(``TrajectoryCache.raw_path``) ahead of the consumer, so a batch's files are read in
parallel and without the npz decompression. The library is built at first use with
``g++ -O2 -shared -fPIC -pthread`` into the gitignored ``csrc/_build/``, named by a hash
of the source and the flags, as ``ops/cuda_lib.py`` names the kernels' builds. There is
no fallback: a build that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from enf_pde_tpu_torch.ops.cuda_lib import BUILD_DIR, CSRC_DIR

__all__ = ["SOURCE", "GXX_FLAGS", "NativePrefetcher", "build_library"]

SOURCE = CSRC_DIR / "trajloader.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def build_library(source: Path = SOURCE) -> Path:
    """Compile ``source`` into ``csrc/_build/`` unless that build exists; returns the
    library's path. Raises ``RuntimeError`` with the compiler's output when it fails."""
    source = Path(source)
    key = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{key}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the trajectory prefetcher is built with g++.")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees no half-written file
    return lib


def _load(source: Path) -> ctypes.CDLL:
    with _lock:
        path = build_library(source)
        if path not in _loaded:
            lib = ctypes.CDLL(str(path))
            lib.trajloader_create.restype = ctypes.c_void_p
            lib.trajloader_create.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.trajloader_destroy.restype = None
            lib.trajloader_destroy.argtypes = [ctypes.c_void_p]
            lib.trajloader_submit.restype = ctypes.c_int64
            lib.trajloader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.trajloader_fetch.restype = ctypes.c_int64
            lib.trajloader_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                             ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            _loaded[path] = lib
        return _loaded[path]


class NativePrefetcher:
    """Prefetching reader of raw float32 trajectory files.

    Args:
        num_threads: reader threads.
        max_inflight: files read ahead and not yet fetched; ``submit`` blocks beyond it.
        source: the C++ source to build (default ``csrc/trajloader.cc``).

    A file is a flat float32 dump of one trajectory; its shape comes from the caller
    (``TrajectoryCache.shape``). ``close`` (or leaving a ``with`` block) stops the
    threads.
    """

    def __init__(self, num_threads: int = 2, max_inflight: int = 16, source: Path = SOURCE):
        self._lib = _load(source)
        self.max_inflight = max_inflight
        self._h = self._lib.trajloader_create(num_threads, max_inflight)

    def close(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.trajloader_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def submit(self, path: str) -> int:
        """Queue a file's read; returns the ticket ``fetch`` takes."""
        return int(self._lib.trajloader_submit(self._h, os.fsencode(path)))

    def fetch(self, ticket: int, shape: Tuple[int, ...]) -> np.ndarray:
        """Wait for a ticket's file and return it as float32 ``shape``; raises ``IOError``
        when the read failed or the file does not hold ``prod(shape)`` floats."""
        out = np.empty(int(np.prod(shape)), dtype=np.float32)
        n = self._lib.trajloader_fetch(self._h, ticket,
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        if n == -1:
            raise IOError(f"native fetch of ticket {ticket} failed: the file could not be read")
        if n != out.size:
            raise IOError(f"size mismatch: the file holds {'more' if n == -2 else n} floats, "
                          f"expected {out.size}")
        return out.reshape(shape)

    def load_batch(self, paths: Sequence[str], shape: Tuple[int, ...]) -> np.ndarray:
        """Read every file of ``paths`` (each ``shape``), stacked [len(paths), *shape].

        The reads overlap, at most ``max_inflight`` ahead of the fetches, so a batch
        larger than that streams through instead of blocking ``submit``."""
        ahead = min(len(paths), self.max_inflight)
        tickets = [self.submit(p) for p in paths[:ahead]]
        out = np.empty((len(paths), *shape), dtype=np.float32)
        for i in range(len(paths)):
            try:
                out[i] = self.fetch(tickets[i], shape)
            except IOError:
                for t in tickets[i + 1:]:  # release the reads still held
                    self._lib.trajloader_fetch(self._h, t, None, 0)
                raise
            if ahead < len(paths):
                tickets.append(self.submit(paths[ahead]))
                ahead += 1
        return out
