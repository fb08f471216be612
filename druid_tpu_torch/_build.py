"""Build and load the port's CUDA kernels and its host codec.

Every `csrc/*.cu` compiles with nvcc for sm_90a into its own shared library
with a plain C interface under `build/kernels/` at the repository root, the
first time a kernel is needed in a process; the library is then loaded with
ctypes. Sources compile in parallel (one nvcc per source). A library newer
than its source is reused. Nothing here runs at import time.

Every `csrc/*.cpp` is host C++ (the storage codec, `csrc/host_codec.cpp`):
it compiles with g++ into `build/host/` at its first use (`load_host`).
Several processes may ask at once (the test suite runs in workers): one
builds under a file lock into a temporary name and renames it into place,
the others wait on the lock and load what it built. A failed build raises
with the compiler's output.

    python -m druid_tpu_torch._build     # build every kernel, print seconds
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_all(names: List[str] = ()) -> Dict[str, float]:
    """Compile the named sources (default: every csrc/*.cu) in parallel.
    Returns {name: seconds}. Raises with nvcc's output when one fails; the
    register/spill report (-Xptxas -v) lands in build/kernels/<name>.log."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src, lib = CSRC / f"{name}.cu", _lib_path(name)
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = lib.with_suffix(f".so.{os.getpid()}")
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    secs = {}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        try:
            rc = proc.wait(timeout=900)
        finally:
            log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n{(BUILD_DIR / f'{n}.log').read_text()}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def _host_lib_path(name: str) -> Path:
    return HOST_BUILD_DIR / f"lib{name}.so"


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with g++ into build/host/lib<name>.so unless
    a library newer than the source is there. Safe across processes: the
    build runs under an exclusive lock on build/host/<name>.lock, writes a
    temporary name and renames it into place. Returns the library's path;
    raises RuntimeError with g++'s output when the build fails."""
    src, lib = CSRC / f"{name}.cpp", _host_lib_path(name)
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(HOST_BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
                return lib
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"g++ not found: {src.name} builds with "
                                   f"the host C++ compiler")
            tmp = lib.with_suffix(f".so.{os.getpid()}")
            out = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {src.name}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cpp, built on first use."""
    key = f"host:{name}"
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = _LIBS[key] = ctypes.CDLL(str(build_host(name)))
        return lib


if __name__ == "__main__":
    for n, s in build_all().items():
        print(f"{n}: built in {s:.1f} s")
