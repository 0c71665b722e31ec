"""Find every piece of a cell by its name: nothing here lists cells, kinds or
metrics, so a new one is a new file (and its ``BENCHMARK.json`` entry).

- ``cells/<cell>.json``: the configuration, the traffic mix, the chips and
  the limits of the comparison that decides ``correct``;
- ``configs/<config>.json``: the sizes as run, with source, ``reduced`` and
  ``assumed``;
- ``traffic/<mix>.json``: a traffic mix's parameters, with its ``kind``;
- ``traffic/<kind>.py``: the general runner of a kind of traffic;
- ``reference/<kind>.py``: that kind's plain reference and comparison;
- ``metrics/<metric>.py``: one per-layer metric's reader.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
SPEC = CHECKOUT / "BENCHMARK.json"


def _json(folder: str, name: str) -> dict:
    path = ROOT / folder / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {folder[:-1] if folder.endswith('s') else folder} "
                          f"named {name!r} ({path.relative_to(CHECKOUT)} is missing)")
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    return _json("cells", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(folder: str, name: str):
    path = ROOT / folder / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no module {path.relative_to(CHECKOUT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str):
    """The runner of one kind of traffic (``traffic/<kind>.py``)."""
    return _module("traffic", name)


def reference(name: str):
    """The plain reference of one kind of traffic (``reference/<kind>.py``)."""
    return _module("reference", name)


def metric(name: str):
    """One per-layer metric's reader (``metrics/<metric>.py``)."""
    return _module("metrics", name)


def spec() -> dict:
    return json.loads(SPEC.read_text())


def metrics_of(cell_name: str, section: str, bench: dict | None = None) -> list[dict]:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the cell
    reports: those that list it under ``workloads``, and the end-to-end
    entries without that key, which every cell reports. Every per-layer
    entry lists its cells."""
    bench = spec() if bench is None else bench
    if section == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or cell_name in m["workloads"]]
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
