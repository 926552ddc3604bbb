"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) at first
use, one ``nvcc -c`` process per source, all started together, and the
objects are linked by one ``nvcc -shared`` into one shared library with a
plain C interface, which is loaded with :mod:`ctypes`. The library lands
in ``build/torch_kernels/`` at the root of the checkout, named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads what is there.

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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]


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
    """Compile every source at once (one nvcc process each), then link."""
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [target.with_name(f"{target.stem}.{s.stem}.{tag}.o")
               for s in sources]
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen(
        [nvcc] + NVCC_FLAGS + ["-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(sources, objects)]
    logs, failed = [], []
    for src, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    compile_s = time.perf_counter() - t0
    partial = target.with_name(f"{target.name}.{tag}")
    cmd = [nvcc, "-shared", "-Xcompiler", "-fPIC"] + \
        [str(o) for o in objects] + ["-o", str(partial)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{' '.join(cmd)}\n"
                           f"{res.stdout}")
    os.replace(partial, target)   # atomic: a reader sees all or nothing
    BUILD_INFO.update(
        sources=[s.name for s in sources],
        seconds=time.perf_counter() - t0,
        compile_seconds=compile_s,
        command=" ".join([Path(nvcc).name] + NVCC_FLAGS + ["-c"]),
        ptxas=[ln.strip() for out in logs for ln in out.splitlines()
               if "ptxas" in ln or "Used" in ln or "spill" in ln],
        library=str(target))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float, ctypes.c_longlong)
    lib.zoo_flash_fwd.argtypes = (
        [p] * 6 + [i] * 7 + [f] + [ll] * 13 + [p])
    # q, k, v, dO, kbias, lse, delta, dq | B, H, Lq, Lk, D, dtype, causal |
    # scale | strides (22 long longs), stream
    lib.zoo_flash_bwd_dq.argtypes = [p] * 8 + [i] * 7 + [f] + [p, p]
    lib.zoo_flash_bwd_dkv.argtypes = [p] * 10 + [i] * 7 + [f] + [p, p]
    lib.zoo_dln_fwd.argtypes = [p] * 9 + [i] * 3 + [u, f, f, p]
    # dy, z, bits, gamma, mean, inv, dx, dres, 2 partials, dgamma, dbeta |
    # partial rows, N, D, dtype | thresh, 1/keep, stream
    lib.zoo_dln_bwd.argtypes = [p] * 12 + [i] * 4 + [u, f, p]
    lib.zoo_dln_bwd_blocks.argtypes = [i]
    for fn in (lib.zoo_flash_fwd, lib.zoo_flash_bwd_dq, lib.zoo_flash_bwd_dkv,
               lib.zoo_dln_fwd, lib.zoo_dln_bwd, lib.zoo_dln_bwd_blocks):
        fn.restype = i


def strides_arg(*tensors_and_ints) -> "ctypes.Array":
    """A C ``long long`` array of element strides for a kernel's
    ``strides`` argument: the first three strides of each 4-D tensor given,
    and each int as it is."""
    vals: List[int] = []
    for t in tensors_and_ints:
        if isinstance(t, int):
            vals.append(t)
        else:
            vals.extend(t.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


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


def sass_opcode_counts(library_path: str,
                       opcodes=("HGMMA", "HMMA")) -> Dict[str, Dict[str, int]]:
    """For each kernel symbol (as mangled) in ``cuobjdump -sass`` of the
    built library, how many instructions of each opcode it holds: HGMMA
    is Hopper's warpgroup product (``wgmma``), HMMA the warp-level one
    (``mma.sync``)."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", library_path],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=True).stdout
    pats = {op: re.compile(rf"\b{op}\b") for op in opcodes}
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            current = counts.setdefault(line[len("Function : "):],
                                        dict.fromkeys(opcodes, 0))
        elif current is not None:
            for op, pat in pats.items():
                if pat.search(line):
                    current[op] += 1
    return counts


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
