"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the CPU only when asked to."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "photon_ml_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "photon_ml_torch.estimators" in mods and "photon_ml_torch.ops.fused_glm" in mods
    # the driver slice's packages are in the scan: io, cli, util, diagnostics
    for package in ("io", "cli", "util", "diagnostics"):
        assert any(m.startswith(f"photon_ml_torch.{package}.") for m in mods), package
    assert {"photon_ml_torch.cli.game_training_driver", "photon_ml_torch.io.avro",
            "photon_ml_torch.io.model_io", "photon_ml_torch.transformers",
            # the sparse slice's own copies of the JAX package's host-only modules
            "photon_ml_torch.io.libsvm", "photon_ml_torch.cli.libsvm_to_avro",
            "photon_ml_torch.cli.name_term_feature_bags_driver",
            "photon_ml_torch.cli.feature_indexing_driver",
            # matrix factorization, the host decoders and date ranges
            "photon_ml_torch.models.matrix_factorization",
            "photon_ml_torch.algorithm.mf_coordinate", "photon_ml_torch.io.avro_native",
            "photon_ml_torch.util.date_range",
            # the fused training program and the off-heap and PalDB index stores
            "photon_ml_torch.parallel", "photon_ml_torch.parallel.distributed",
            "photon_ml_torch.io.offheap_index_map", "photon_ml_torch.io.paldb",
            # the mesh: process groups, collectives, the sharded objectives,
            # scoring and device evaluators
            "photon_ml_torch.parallel.multihost", "photon_ml_torch.parallel.mesh",
            "photon_ml_torch.parallel.sharded_dense", "photon_ml_torch.parallel.scoring",
            "photon_ml_torch.evaluation.sharded",
            # partitioned I/O: each rank's slice of the input
            "photon_ml_torch.io.partitioned_reader",
            # diagnostics, the run journal, tracing, solver telemetry, events
            "photon_ml_torch.diagnostics.report_builder", "photon_ml_torch.telemetry.journal",
            "photon_ml_torch.telemetry.tracing", "photon_ml_torch.telemetry.solver_trace",
            "photon_ml_torch.util.events",
            # the program ledger, the probes, the verdicts and the bench history
            "photon_ml_torch.telemetry.program_ledger", "photon_ml_torch.telemetry.probes",
            "photon_ml_torch.telemetry.verdicts",
            "photon_ml_torch.telemetry.bench_history"} <= set(mods)
    # the mesh tests' rank processes import the port only
    mods = mods + ["tests.torch_mesh_worker"]
    script = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_clean_env(), cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "tests/torch_mesh_worker.py"])
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_host_libraries_build_from_the_ports_own_sources():
    """The port's build code and chip_smoke.py never name the JAX package's
    native directory (its sources or its prebuilt libraries); the C++
    sources the port builds sit in photon_ml_torch/native and every host
    library the port loads is one of them."""
    from photon_ml_torch import build

    for path in [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert "photon_ml_tpu/native" not in text and "photon_ml_tpu.native" not in text, path
    assert build.NATIVE == PORT / "native"
    sources = {p.stem for p in (PORT / "native").glob("*.cpp")}
    assert sources == {"avro_decoder", "libsvm_loader", "offheap_store"}
    loaded = set()
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "load_host":
                loaded.add(node.args[0].value)
    assert loaded == sources
    assert build.HOST_BUILD_DIR == REPO / "build" / "torch_native"


def test_offheap_store_loads_only_the_ports_library(tmp_path):
    """Building and reading an off-heap store through the port, in a fresh
    process, maps no shared library of the JAX package's native directory
    (its checked-in or cached builds) and imports no JAX."""
    script = (
        "import json, sys\n"
        "from photon_ml_torch.io.offheap_index_map import OffHeapIndexMap, build_offheap_store\n"
        "from photon_ml_torch.io.index_map import IndexMap\n"
        f"build_offheap_store({str(tmp_path)!r}, {{'a': 0, 'b': 1}}, num_partitions=2)\n"
        f"m = IndexMap.load_directory({str(tmp_path)!r})['index']\n"
        "assert isinstance(m, OffHeapIndexMap) and m.get_index('b') == 1\n"
        "maps = [line.split()[-1] for line in open('/proc/self/maps') if '.so' in line]\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'libs': sorted(set(maps)), 'bad': bad}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_clean_env(), cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    ours = [p for p in result["libs"] if "liboffheap_store-" in p]
    assert ours and all(p.startswith(str(REPO / "build" / "torch_native")) for p in ours)
    assert not [p for p in result["libs"] if "photon_ml_tpu" in p], result["libs"]


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = _clean_env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_device_policy(monkeypatch):
    from photon_ml_torch import device
    from photon_ml_torch.data.batch import LabeledPointBatch

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LabeledPointBatch.create(np.zeros((2, 2)), np.zeros(2))
    b = LabeledPointBatch.create(np.zeros((2, 2)), np.zeros(2), device="cpu")
    assert b.features.device.type == "cpu"


def test_batch_helpers():
    from photon_ml_torch.data.batch import (
        LabeledPointBatch,
        compute_margins,
        solve_dtype_of,
        summarize,
    )
    from photon_ml_tpu.data.batch import summarize as jax_summarize

    x = np.arange(12.0).reshape(4, 3)
    b = LabeledPointBatch.create(x, np.ones(4), device="cpu")
    p = b.pad_to(6)
    assert p.num_samples == 6 and p.weights[4:].tolist() == [0.0, 0.0]
    with pytest.raises(ValueError):
        p.pad_to(5)
    assert b.pad_to(4) is b
    b2 = b.add_scores_to_offsets(torch.ones(4, dtype=torch.float64))
    assert b2.offsets.tolist() == [1.0] * 4 and b.with_offsets(b2.offsets).offsets is b2.offsets
    w = torch.tensor([1.0, 0.0, -1.0], dtype=torch.float64)
    assert compute_margins(b2, w).tolist() == [-1.0, -1.0, -1.0, -1.0]
    assert solve_dtype_of(torch.bfloat16) == torch.float32
    assert solve_dtype_of(torch.float64) == torch.float64
    ws = np.array([1.0, 2.0, 0.5, 1.0])
    port, ref = summarize(x, ws), jax_summarize(x, ws)
    for k in ref:
        np.testing.assert_allclose(np.asarray(port[k]), np.asarray(ref[k]))


def test_normalization_round_trip():
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
    from tests.torch_parity import normalizations, to_np

    import jax.numpy as jnp

    x = np.random.default_rng(0).normal(size=(50, 5)) * 3 + 1
    x[:, 0] = 1.0
    for kind in ("SCALE_WITH_MAX_MAGNITUDE", "STANDARDIZATION"):
        jn, tn = normalizations(kind, x, intercept_index=0)
        w = np.random.default_rng(1).normal(size=5)
        wm = tn.to_model_space(torch.from_numpy(w), 0)
        np.testing.assert_allclose(to_np(wm), to_np(jn.to_model_space(jnp.asarray(w), 0)),
                                   rtol=1e-12)
        np.testing.assert_allclose(to_np(tn.from_model_space(wm, 0)), w, rtol=1e-10)
        np.testing.assert_allclose(
            to_np(tn.variances_to_model_space(torch.ones(5, dtype=torch.float64))),
            to_np(jn.variances_to_model_space(jnp.ones(5))), rtol=1e-12)
    t = torch.from_numpy
    none = build_normalization(NormalizationType.NONE, mean=t(x.mean(0)),
                               variance=t(x.var(0)), max_magnitude=t(np.abs(x).max(0)))
    assert none.is_identity
