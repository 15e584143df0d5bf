"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` source compiles on first use into a shared library with a
plain C interface, under ``build/kernels/`` at the repository root (listed in
``.gitignore``).  The library name carries a hash of the source, so an edited
kernel is rebuilt and a stale build is never loaded.  Nothing here runs at
import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}
#: per-source build record: seconds spent in nvcc (0.0 when reused) and the
#: compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_source(src: Path, out: Path) -> str:
    """Compile the CUDA source ``src`` into the shared library ``out`` with
    the port's flags; returns the compiler's ``-Xptxas -v`` report."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: concurrent builders never see half a file
    return proc.stderr


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact source is built already."""
    out = library_path(name)
    if out.exists():
        build_log.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return out
    t0 = time.perf_counter()
    ptxas = compile_source(CSRC / f"{name}.cu", out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas}
    return out


def sources() -> List[str]:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Build every kernel source at once: one ``nvcc`` per source, all
    started together.  Raises the first build failure."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib
