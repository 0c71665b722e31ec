"""The port's program labels are the JAX package's: an AST scan of both
packages finds every labelled site (``ledger_jit`` in the JAX package,
``ledger_call`` in the port, called or applied through ``partial``) and
holds the two label sets equal, less the JAX labels named below with the
reason the port has no such program. The counterpart of
``dev/lint_parity.py`` check 13 (every hot jit site labelled).
"""

import ast
import functools
from pathlib import Path

import pytest

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

REPO = Path(__file__).resolve().parents[1]

#: JAX labels with no counterpart function in the port, each with its reason
NOT_PORTED: dict = {}


def _wrapper_name(node) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@functools.lru_cache(maxsize=None)
def labels(package: str, wrapper: str) -> dict:
    """label -> [file:line, ...] of every ``wrapper(fn, label="...")`` and
    ``partial(wrapper, label="...")`` in ``package``."""
    out: dict = {}
    for path in sorted((REPO / package).rglob("*.py")):
        if path.name == "program_ledger.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            name = _wrapper_name(node.func)
            if name == "partial" and node.args:
                name = _wrapper_name(node.args[0])
            if name != wrapper:
                continue
            for kw in node.keywords:
                if kw.arg == "label":
                    assert isinstance(kw.value, ast.Constant), \
                        f"{path}:{node.lineno}: a label must be a string literal"
                    out.setdefault(kw.value.value, []).append(
                        f"{path.relative_to(REPO)}:{node.lineno}")
    return out


def test_the_ports_labels_are_the_jax_packages():
    jax_labels = labels("photon_ml_tpu", "ledger_jit")
    port_labels = labels("photon_ml_torch", "ledger_call")
    assert len(jax_labels) >= 40
    assert set(port_labels) == set(jax_labels) - set(NOT_PORTED)
    assert set(NOT_PORTED) <= set(jax_labels)


def test_each_label_has_one_site_in_the_port():
    """A label names one program: one site each (the variance functions'
    full and diagonal modes are two labels over one function)."""
    for label, sites in labels("photon_ml_torch", "ledger_call").items():
        assert len(sites) == 1, (label, sites)


@pytest.mark.parametrize("prefix", ["coord/", "scheduler/", "streaming/", "streaming_game/",
                                    "train/", "refresh/", "glm/", "search/", "score/",
                                    "serve/"])
def test_every_label_family_is_present(prefix):
    port = labels("photon_ml_torch", "ledger_call")
    assert any(label.startswith(prefix) for label in port), prefix
