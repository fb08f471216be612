"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` compiles with nvcc for sm_90a into its own shared library
with a plain C interface under `build/kernels/` at the repository root, the
first time a kernel is needed in a process; the library is then loaded with
ctypes. Sources compile in parallel (one nvcc per source). A library newer
than its source is reused. Nothing here runs at import time.

    python -m druid_tpu_torch._build     # build every kernel, print seconds
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
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


if __name__ == "__main__":
    for n, s in build_all().items():
        print(f"{n}: built in {s:.1f} s")
