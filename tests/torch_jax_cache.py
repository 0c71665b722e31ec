"""Give the test processes a locked JAX persistent compilation cache of their
own checkout.

The test configuration points every process at one fixed persistent cache
directory, which every checkout on the machine shares. Without a size
limit, JAX writes an entry with a plain ``write_bytes`` and reads it with a
plain ``read_bytes``, under no lock (``jax/_src/lru_cache.py``,
``LRUCache.get``/``put``), so a pytest-xdist worker can read an entry that
another process is still writing.

:func:`lock_persistent_cache` moves the process to a cache directory under
``tempfile.gettempdir()``, which follows the checkout's ``TMPDIR``, and gives
it a size limit, which turns on the cache's file lock around every read and
write. The workers of one run share that directory, and all of them lock.
The limit is far above what the suite writes, so nothing is evicted. It
runs when the port's parity helpers are imported, which every worker does
while collecting the suite, before its first test.

The directory persists from run to run on purpose: with it cold, the whole
suite under xdist does not finish inside its time limit. An entry that a
killed run left torn is harmless (JAX warns that it does not decompress and
compiles again).

A worker that died of a segmentation fault inside XLA:CPU had run out of
memory maps, not read a bad entry: ``tests/torch_jax_maps.py`` (ROADMAP
C.5).
"""

from __future__ import annotations

import os
import tempfile

#: the cache size limit that turns the lock on (1 TiB: nothing is evicted)
CACHE_LIMIT_BYTES = 1 << 40


def cache_dir() -> str:
    """The persistent cache directory of this checkout's test processes."""
    return os.path.join(tempfile.gettempdir(), "photon_ml_torch_tests_jax_cache")


def lock_persistent_cache() -> None:
    """Point the persistent cache at :func:`cache_dir` with a size limit
    (and so its file lock), and drop an already-built cache object so the
    next compile rebuilds it there. Idempotent."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    path = cache_dir()
    if (jax.config.jax_compilation_cache_dir == path
            and jax.config.jax_compilation_cache_max_size == CACHE_LIMIT_BYTES):
        return
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_max_size", CACHE_LIMIT_BYTES)
    compilation_cache.set_cache_dir(path)
    compilation_cache.reset_cache()
