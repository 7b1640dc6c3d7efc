"""Build and load the port's CUDA kernels.

`load()` compiles every `csrc/*.cu` on first use, one nvcc process a source,
all started together (the build costs the slowest source, not their sum),
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c

links the objects into one shared library with a plain C interface in
`kytpu_torch/_build/<hash of the sources>/`, and loads it with ctypes.
`ptxas_report` keeps what `-Xptxas -v` said of each kernel (registers,
stack frame, spills).
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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC"]

_LIB = None
build_seconds = None   # wall time of the build this process ran, if any
nvcc_seconds = {}      # each source's nvcc -c time in that build
ptxas_report = ""      # -Xptxas -v lines of that build


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
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libkytpu_kernels.so"


def _compile(nvcc: str, src: Path, obj: Path) -> tuple[str, float]:
    """nvcc -c one source -> (-Xptxas -v's report, seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          str(obj), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):\n"
                           f"{res.stderr}")
    return res.stderr, time.perf_counter() - t0


def build() -> Path:
    """Compile the sources unless this exact build exists; returns the
    library's path."""
    global build_seconds, nvcc_seconds, ptxas_report
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = _sources()
    t0 = time.perf_counter()
    # objects and the unlinked library live in a directory removed on
    # success and failure alike; os.replace is atomic, so concurrent
    # builders never see half a library
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp, \
            ThreadPoolExecutor(len(srcs)) as pool:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        done = list(pool.map(_compile, [nvcc] * len(srcs), srcs, objs))
        res = subprocess.run([nvcc, "-shared", "-o", f"{tmp}/{lib.name}",
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(f"{tmp}/{lib.name}", lib)
    build_seconds = time.perf_counter() - t0
    nvcc_seconds = {src.name: secs for src, (_, secs) in zip(srcs, done)}
    ptxas_report = "\n".join(
        line.strip() for log, _ in done for line in log.splitlines()
        if "Used" in line or "spill" in line or "Compiling entry" in line)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Pointers and the stream are
    c_void_p, ints c_int."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kytpu_wavefront_fwd.argtypes = [p] * 16 + [i] * 11 + [p]
        lib.kytpu_wavefront_fwd_res.argtypes = [p] * 18 + [i] * 11 + [p]
        lib.kytpu_wavefront_bwd_res.argtypes = [p] * 21 + [i] * 7 + [p]
        lib.kytpu_wavefront_bwd_replay.argtypes = [p] * 25 + [i] * 15 + [p]
        lib.kytpu_wavefront_chunk.argtypes = [i] * 7
        lib.kytpu_bigscene_fwd.argtypes = [p] * 24 + [i] * 17 + [p]
        lib.kytpu_bigscene_bwd_res.argtypes = [p] * 13 + [i] * 7 + [p, p]
        q = ctypes.c_longlong
        lib.kytpu_tag_sort_scratch.argtypes = [i, i]
        lib.kytpu_tag_sort_scratch.restype = q
        lib.kytpu_tag_sort.argtypes = [p, i, i, i, p, p, p, q, p]
        lib.kytpu_segment_sums.argtypes = [p] * 5 + [q, p] + [i] * 5 + [p]
        lib.kytpu_bigscene_bwd_replay.argtypes = [p] * 29 + [i] * 17 + [p, p]
        for fn in (lib.kytpu_wavefront_fwd, lib.kytpu_wavefront_fwd_res,
                   lib.kytpu_wavefront_bwd_res,
                   lib.kytpu_wavefront_bwd_replay, lib.kytpu_wavefront_chunk,
                   lib.kytpu_bigscene_fwd,
                   lib.kytpu_bigscene_bwd_res,
                   lib.kytpu_tag_sort, lib.kytpu_segment_sums,
                   lib.kytpu_bigscene_bwd_replay):
            fn.restype = i
        _LIB = lib
    return _LIB


if __name__ == "__main__":
    path = build()
    print(f"{path} (built in {build_seconds:.1f} s; nvcc -c {nvcc_seconds})"
          f"\n{ptxas_report}" if build_seconds else f"{path} (already built)")
