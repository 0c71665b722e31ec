"""The check that the process never loaded JAX or the JAX package.

Compared by whole top-level module names (the part before the first dot):
the port's own name, ``photon_ml_torch``, begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "photon_ml_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are JAX's
    or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
