"""Build and load the port's CUDA kernels.

`load()` compiles every `csrc/*.cu` into one shared library with a plain C
interface, on first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC

into `kytpu_torch/_build/<hash of the sources>/`, and loads it with ctypes.
`--fmad=false` (and no fast math) keeps the kernels' rounding equal to their
plain PyTorch versions. Nothing here runs at import time, and no CUDA
toolkit is needed to import the package.

    python -m kytpu_torch.kernels.build     # build now, print the time
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
build_seconds = None   # wall time of the build this process ran, if any


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libkytpu_kernels.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; returns the
    library's path."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources()]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never see half a file
    build_seconds = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Pointers and the stream are
    c_void_p, ints c_int."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kytpu_wavefront_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.kytpu_wavefront_fwd.restype = i
        _LIB = lib
    return _LIB


if __name__ == "__main__":
    path = build()
    print(f"{path} (built in {build_seconds:.1f} s)" if build_seconds
          else f"{path} (already built)")
