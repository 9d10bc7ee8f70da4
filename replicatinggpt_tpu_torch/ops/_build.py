"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers it
includes) has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``), then loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so
an edited source rebuilds at its next use and an unchanged one loads
the library already built. Nothing is built at import time: the first
wrapper call on a CUDA tensor builds. Processes that build one kernel at
once (a fleet's cold workers) compile it once: each build takes the
kernel's ``flock`` and looks for the library again under it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are compiled at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path. ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report (registers, shared memory, spills) per kernel
    function."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():        # another process built it meanwhile
            return out
        _compile(name, out, verbose)
    return out


def _compile(name: str, out: Path, verbose: bool) -> None:
    # compile to a temporary name in the same directory, then rename: an
    # interrupted build never leaves a half-written .so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        if verbose:
            print("".join(line for line in proc.stderr.splitlines(True)
                          if "Compiling entry function" not in line), end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
