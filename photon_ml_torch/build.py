"""Build the port's CUDA kernels from ``photon_ml_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (loaded with ``ctypes``) under ``build/torch_kernels/`` of
the checkout. The file name carries a hash of the source (with the csrc files
it includes) and the flags, so
an edited source builds anew and an unchanged one is reused. Nothing is
built at import time: the CPU tests import every module without ``nvcc``.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds one source if needed and returns its library.
``on_device`` and ``check_cuda`` are the two steps every wrapper takes around
a launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source_bytes(path: Path) -> bytes:
    """A source with every ``#include "..."`` of a csrc file appended, so a
    library is rebuilt when a file it includes changes."""
    src = path.read_bytes()
    for line in src.decode().splitlines():
        if line.startswith('#include "'):
            src += _source_bytes(CSRC / line.split('"')[1])
    return src


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the library path."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, float]:
    """Build every source in parallel; returns seconds per source (0 for a
    library that was already built)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in sources()}
    seconds = {}
    for name, (proc, out) in started.items():
        _finish(name, proc, out)
        seconds[name] = 0.0 if proc is None else time.perf_counter() - t0
    return seconds


def on_device(dev):
    """Make ``dev`` the current CUDA device for a launch, if it is not already."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check_cuda(err: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a kernel's C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        started, out = _start(name)
        _finish(name, started, out)
        lib = _LOADED[name] = ctypes.CDLL(str(out))
    return lib
