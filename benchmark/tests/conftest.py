"""The benchmark's own tests: the harness on the CPU at small sizes, and (marked
``cuda``) the controls on the card.

    python -m pytest -p no:cacheprovider benchmark/tests

They import no JAX. ``benchmark/`` and the checkout's root go on the path as
``benchmark/run.py`` puts them.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE.parents[1])):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is False",
    )
