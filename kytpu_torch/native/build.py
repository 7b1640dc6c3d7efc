"""Build the native film encoder with g++: `python -m
kytpu_torch.native.build` writes kytpu_torch/_build/libkyfilm.so."""

from __future__ import annotations

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).parent
SRC = HERE / "film_io.cpp"
BUILD_DIR = HERE.parent / "_build"
LIB_NAME = "libkyfilm.so"


def build(verbose: bool = True,
          out_dir: pathlib.Path | str = BUILD_DIR) -> pathlib.Path:
    """Compile film_io.cpp into out_dir/libkyfilm.so -> its path."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o",
           str(lib)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return lib


if __name__ == "__main__":
    print(f"built {build()}", file=sys.stderr)
