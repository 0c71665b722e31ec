"""A pytest plugin that keeps a test process's XLA:CPU executables, and so
its memory maps, below the kernel's per-process limit. The port's test
modules name it in ``pytest_plugins``.

Every XLA:CPU executable a process holds keeps about three memory maps, and
JAX's in-memory caches hold every executable the process compiled or
loaded. The port's tests run many small JAX programs (op by op under
``vmap``), so a pytest-xdist worker that runs a few hundred of them passes
the kernel's limit (``vm.max_map_count``, 65530 by default). There the next
compile, persistent-cache read or cache write fails to map its code ("LLVM
compilation error: Cannot allocate memory") and the worker dies of a
segmentation fault inside XLA:CPU, failing the test it ran (ROADMAP C.5).
After each of the port's tests, :func:`release_executables` drops JAX's
in-memory caches once the process holds half the limit; the next call of a
dropped program compiles again or reads the persistent cache.
"""

from __future__ import annotations

import gc
import sys

import pytest

#: the share of the per-process memory-map limit at which a test process
#: drops JAX's in-memory executables
MAP_SHARE = 0.5

#: the kernel's default ``vm.max_map_count``
DEFAULT_MAP_LIMIT = 65530


def map_limit() -> int:
    """The kernel's limit on one process's memory maps."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return DEFAULT_MAP_LIMIT


def map_count() -> int | None:
    """This process's memory maps, or None where ``/proc`` does not say."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return None


def release_executables(share: float = MAP_SHARE) -> bool:
    """Drop JAX's in-memory caches, and with them the executables they
    hold, when this process's memory maps have reached ``share`` of the
    limit. Returns whether it did."""
    if "jax" not in sys.modules:
        return False
    count = map_count()
    if count is None or count < share * map_limit():
        return False
    sys.modules["jax"].clear_caches()
    gc.collect()
    return True


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    """After each of the port's tests, keep the process's memory maps below
    the limit (a test of the JAX package's own is left as it runs)."""
    if item.path.name.startswith("test_torch_"):
        release_executables()
