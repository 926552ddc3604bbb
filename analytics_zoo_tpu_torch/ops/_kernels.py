"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) at first
use by one ``nvcc ... -shared`` command into one shared library with a
plain C interface, which is loaded with :mod:`ctypes`. The library lands in ``build/torch_kernels/``
at the root of the checkout, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads what is there.

Nothing here runs at import time: the CPU tests import every module, and
this machine-independent part must import without a CUDA toolkit.

:data:`LAUNCHES` counts kernel launches by name. A wrapper adds one right
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]


class LaunchCounter:
    """Thread-safe launch counts by kernel name (serving threads launch
    concurrently, and a lost increment would break the launch check)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchCounter()

#: what the last build did: sources, seconds, the nvcc command and the
#: ``-Xptxas -v`` lines (registers, shared memory, spills)
BUILD_INFO: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels build at first use on a "
            "machine with the CUDA toolkit")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and every source and header under ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, sources: List[Path]) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc] + NVCC_FLAGS + [str(s) for s in sources] + \
        ["-o", str(partial)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}")
    os.replace(partial, target)   # atomic: a reader sees all or nothing
    BUILD_INFO.update(
        sources=[s.name for s in sources],
        seconds=time.perf_counter() - t0,
        command=" ".join([Path(nvcc).name] + NVCC_FLAGS),
        ptxas=[ln.strip() for ln in res.stdout.splitlines()
               if "ptxas" in ln or "Used" in ln or "spill" in ln],
        library=str(target))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.zoo_flash_fwd.argtypes = (
        [p] * 6 + [i] * 7 + [f] + [ll] * 13 + [p])
    lib.zoo_flash_fwd.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set has not
    been built yet."""
    global _lib
    with _lib_lock:
        if _lib is None:
            sources = _sources()
            target = BUILD_DIR / f"libzoo_kernels_{_digest()}.so"
            if not target.exists():
                _build(target, sources)
            else:
                BUILD_INFO.update(sources=[s.name for s in sources],
                                  seconds=0.0, library=str(target),
                                  cached=True)
            lib = ctypes.CDLL(str(target))
            _bind(lib)
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
