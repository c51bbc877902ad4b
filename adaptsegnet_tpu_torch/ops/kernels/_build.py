"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles alone into
`_build/lib<name>-<hash>.so` (the hash covers the source, the shared
`csrc/*.cuh` headers and the flags, so an edited source is rebuilt). Nothing is built when a module is imported:
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

import torch

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
    for header in sorted(CSRC.glob("*.cuh")):  # shared by several sources
        digest.update(header.read_bytes())
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


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raises for any other device: no fallback."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return True


def check_operands(what: str, device: torch.device, **tensors) -> None:
    """Every operand of a launch lies on `device`, is bf16 and contiguous:
    the kernels read raw pointers with those layouts."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, expected {device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the kernels' last argument.
    Operands are allocated and freed on this stream too, so the caching
    allocator reuses their memory only after the launch has run."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, what: str) -> None:
    """Raise if a launch returned a cudaError_t other than cudaSuccess."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")
