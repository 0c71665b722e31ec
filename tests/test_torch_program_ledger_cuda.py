"""The program ledger on the card: CUDA graph captures as compiles.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_program_ledger_cuda.py

The resident scorer's first capture under ``serve/score`` is a
``program_compile`` row; a request whose sparse entry axis pads to another
power of two captures again, and its ``program_recompile`` row names the
entry-axis leaves and their old and new shapes; a replay of a captured
signature compiles nothing; the scores are bitwise those of a scorer with
no ledger installed. With memory analysis on, a capture reports its graph
pool's bytes and the card's total memory.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.data.game_data import slice_game_dataset
from photon_ml_torch.serving import ResidentScorer
from photon_ml_torch.telemetry import journal as tj
from photon_ml_torch.telemetry import probes
from photon_ml_torch.telemetry import program_ledger as tl
from photon_ml_torch.telemetry import registry as treg
# the serving tests' fixtures, by the module name pytest gives them (a
# ``tests`` package installed on the card's machine can shadow this directory)
from test_torch_serving_cuda import _fixture, _model

pytestmark = pytest.mark.cuda

SHAPES = (16, 64, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _requests(ds):
    """Requests of one bucket whose entry axes pad to 256, 512 and 1024
    entries, then a replay of the first."""
    return [slice_game_dataset(ds, lo, hi) for lo, hi in
            ((100, 116), (100, 130), (100, 160), (100, 116))]


def _serve(model, requests, ledger=None):
    scorer = ResidentScorer(model, shapes=SHAPES)
    if ledger is not None:
        tl.install_ledger(ledger)
    try:
        scores = [scorer.score(r) for r in requests]
    finally:
        if ledger is not None:
            tl.uninstall_ledger()
    return scorer, scores


def test_captures_are_compiles_and_recompiles_name_the_entry_axis(cuda, tmp_path):
    ds, values = _fixture("sparse", cuda)
    model = _model(values, cuda)
    requests = _requests(ds)
    _, plain = _serve(model, requests)
    journal = tj.RunJournal(tmp_path)
    ledger = tl.ProgramLedger(registry=treg.MetricsRegistry(), journal=journal)
    scorer, observed = _serve(model, requests, ledger)
    journal.close()
    for a, b in zip(plain, observed):
        assert np.array_equal(a, b)
    rows = tj.read_journal(tmp_path / "run-journal.jsonl")
    compiles = [r for r in rows if r["kind"] == "program_compile"]
    recompiles = [r for r in rows if r["kind"] == "program_recompile"]
    snap = ledger.snapshot()["serve/score"]
    assert scorer.captures >= 2
    assert len(compiles) == snap["compiles"] == scorer.captures
    assert len(recompiles) == snap["recompiles"] == scorer.captures - 1
    assert snap["calls"] == len(requests) and snap["signatures"] == scorer.captures
    for row in recompiles:
        shapes = {c["leaf"]: (c["old"], c["new"]) for c in row["changed"]
                  if c["field"] == "shape"}
        assert any(leaf.startswith("arg0.fe/") for leaf in shapes), row
        for old, new in shapes.values():
            assert old != new
    assert all(r["compile_seconds"] > 0 and r["label"] == "serve/score" for r in compiles)


def test_memory_analysis_reports_the_graph_pool(cuda, tmp_path):
    ds, values = _fixture("dense", cuda)
    model = _model(values, cuda)
    journal = tj.RunJournal(tmp_path)
    ledger = tl.ProgramLedger(registry=treg.MetricsRegistry(), journal=journal,
                              analyze_memory=True)
    _serve(model, [slice_game_dataset(ds, 0, 10)], ledger)
    journal.close()
    row, = [r for r in tj.read_journal(tmp_path / "run-journal.jsonl")
            if r["kind"] == "program_compile"]
    assert row["memory"]["temp_size_in_bytes"] > 0
    assert row["device_bytes_limit"] == torch.cuda.mem_get_info(cuda)[1]
    assert row["hbm_forecast_bytes"] >= row["memory"]["temp_size_in_bytes"]


def test_device_memory_probes(cuda):
    x = torch.empty(1 << 20, device=cuda)
    assert probes.live_buffer_bytes() == torch.cuda.memory_allocated(cuda)
    assert probes.live_buffer_bytes(cuda) >= x.numel() * 4
    assert probes.device_memory_limit_bytes() == torch.cuda.mem_get_info(cuda)[1]
