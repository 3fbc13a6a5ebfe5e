"""Build the port's CUDA kernels from the checkout's sources at first use.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). Libraries go to
``build/torch_kernels/`` in the checkout, named by a hash of their source
and of the shared headers (``csrc/*.cuh``), so an edited source rebuilds
and an unchanged one is reused. ``build``
starts one ``nvcc`` per source, all together.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("paged_decode", "flash_fwd", "flash_bwd", "grouped_matmul", "fused_linear_stats")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's output) of builds made by this process
build_log: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: CUDA kernels build only on a CUDA host")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def compile_sources(jobs: Dict[str, tuple]) -> Dict[str, tuple]:
    """Compile ``name -> (source .cu, library .so)`` with one ``nvcc`` per
    source, all started together. Returns name -> (seconds, nvcc's
    output); raises with the compiler's output if any build fails. Each
    library is written under a temporary name and renamed when complete."""
    procs = {}
    t0 = time.perf_counter()
    for n, (src, lib) in jobs.items():
        tmp = Path(lib).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[n] = (tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, lib, proc) in procs.items():
        output, _ = proc.communicate()
        logs[n] = (time.perf_counter() - t0, output)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every listed kernel whose library is missing (see
    compile_sources). Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    build_log.update(compile_sources(
        {n: (CSRC / f"{n}.cu", path) for n, path in paths.items() if not path.exists()}))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
