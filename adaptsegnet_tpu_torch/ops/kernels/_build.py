"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles alone into
`_build/lib<name>-<hash>.so` (the hash covers the source and the flags, so
an edited source is rebuilt). Nothing is built when a module is imported:
the first call that launches a kernel builds its library, and `build()`
compiles several at once, one nvcc per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every library in `names` that is not built yet, in parallel.

    Returns {name: nvcc's output (ptxas register and spill lines)} for the
    ones compiled; raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{logs[name]}" for name in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library `name`, compiled first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))

