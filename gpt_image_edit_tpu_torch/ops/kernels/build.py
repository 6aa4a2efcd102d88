"""Build and load the port's CUDA kernels.

Every kernel source is one `csrc/<name>.cu` with a plain C interface (it may
include the shared `csrc/*.cuh` headers). `build` compiles sources with
`nvcc` for sm_90a into `build/kernels/` at the repo root, one nvcc process
per source, all started together; a library is keyed by the hash of its
source and of the headers, so an edited kernel builds anew and an unchanged
one is reused. `kernel_function` loads a built kernel's entry with ctypes.
Nothing here runs at import: a kernel builds on its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_FUNCTIONS: Dict[Tuple[str, str], Any] = {}  # loaded entries, by (source, symbol)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu lands (its name carries the hash)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"libgie_{name}_{digest.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> Path:
    """nvcc's -Xptxas -v output (registers, spills) beside the library."""
    out = library_path(name)
    return out.with_name(out.stem + ".ptxas.txt")


def build(names: Iterable[str]) -> List[Path]:
    """Compile csrc/<name>.cu for each name not built yet, in parallel, and
    return the libraries' paths in order. Raises if any nvcc fails."""
    names = list(names)
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{err}")
            continue
        out.with_name(out.stem + ".ptxas.txt").write_text(err)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def kernel_function(name: str, symbol: str, argtypes):
    """The C function `symbol` of csrc/<name>.cu, built and loaded on first
    use (then cached); it returns the cudaError_t of its launch as an int.
    Pass a pointer or the stream as ctypes.c_void_p: an untyped Python int
    would be cut to 32 bits."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build([name])[0])), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn
