"""ctypes loader for the host data-ops library (``native/dataops.cc``).

The port's own copy of ``load_dataops`` in the JAX package's
``runtime/native.py``: the same C++ source and entry point
(``tpuj_augment``, the crop and flip gather of ``train/data.py``'s
``augment_images``), built at first use with ``g++ -std=c++17 -O2 -fPIC
-pthread -shared`` into ``build/torch_kernels/`` (git-ignored), under a
name carrying a hash of the source, so an edited source rebuilds. An
``flock`` on a lock file beside the library serialises concurrent builds
(processes of one host may race here); the compiler writes a temporary
file that is renamed into place, so no process loads a half-written
library. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "dataops.cc"
BUILD_DIR = REPO / "build" / "torch_kernels"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """The library's path: ``dataops-<source hash>.so`` in BUILD_DIR."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"dataops-{digest}.so"


def ensure_built() -> Path:
    """Compile the library unless it exists. Raises RuntimeError with the
    compiler's output when the build fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native source not found: {SOURCE}")
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(str(path) + ".buildlock", os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if path.exists():  # another process built it while this one waited
            return path
        tmp = path.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"dataops build failed to run: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"dataops build failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
        return path
    finally:
        os.close(fd)


def load_dataops() -> ctypes.CDLL:
    """The loaded library (building it first if needed); cached."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(ensure_built()))
            lib.tpuj_augment.restype = ctypes.c_int
            lib.tpuj_augment.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ]
            _lib = lib
        return _lib
