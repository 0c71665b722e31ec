"""Build the port's CUDA kernels and host libraries at first use.

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

The host libraries (``native/<name>.cpp``: the columnar Avro decoder and the
LibSVM parser) build the same way with ``g++`` into ``build/torch_native/``:
``load_host(name, configure)``. A build that fails raises ``RuntimeError``
with the compiler's output; nothing falls back on its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
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

NATIVE = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_native"
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
#: per-source link flags: only the Avro decoder needs zlib (deflate blocks)
HOST_LINK = {"avro_decoder": ("-lz",)}

_LOADED: dict[str, ctypes.CDLL] = {}
_HOST_LOADED: dict[str, ctypes.CDLL] = {}


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


def host_library_path(name: str) -> Path:
    src = (NATIVE / f"{name}.cpp").read_bytes()
    flags = " ".join(HOST_FLAGS + HOST_LINK.get(name, ()))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return HOST_BUILD_DIR / f"lib{name}-{digest}.so"


def _gxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("no C++ compiler (g++) found: the host libraries of "
                           "photon_ml_torch/native are built with one")
    return path


def _build_host(name: str, out: Path) -> None:
    """Compile native/<name>.cpp into ``out`` through a temporary file
    (several processes may build at once). A zlib that ``-lz`` does not
    find (no development link) is linked by its library name."""
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = list(HOST_LINK.get(name, ()))
    attempts = [link]
    zlib = ctypes.util.find_library("z")
    if "-lz" in link and zlib:
        attempts.append([f if f != "-lz" else f"-l:{zlib}" for f in link])
    log = ""
    for flags in attempts:
        cmd = [_gxx(), *HOST_FLAGS, str(NATIVE / f"{name}.cpp"), "-o", str(tmp), *flags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return
        log += f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    with contextlib.suppress(FileNotFoundError):
        tmp.unlink()
    raise RuntimeError(f"g++ failed for photon_ml_torch/native/{name}.cpp:\n{log}")


def load_host(name: str, configure) -> ctypes.CDLL:
    """The loaded host library of ``native/<name>.cpp``, built first if
    needed; ``configure(lib)`` declares its functions' types once."""
    lib = _HOST_LOADED.get(name)
    if lib is None:
        out = host_library_path(name)
        if not out.exists():
            _build_host(name, out)
        lib = ctypes.CDLL(str(out))
        configure(lib)
        _HOST_LOADED[name] = lib
    return lib
