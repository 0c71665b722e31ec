"""``correct`` against faults and controls, at sizes a test run holds.

On the CPU, each cell's run is driven whole (the look for a card skipped)
with the program broken underneath: a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest,
an answer altered where it is produced. Each must come out not correct; the
same run unbroken must come out correct. The cells run on one card, so no
exchange between cards exists to leave out.

The controls (the reference in TF32 in the program's place for a λ path,
the program's own TF32 path for a GAME fit) must come out not correct too:
the λ path's on the CPU, the GAME fit's on the card (the TF32 kernel runs
only there).
"""

import time

import pytest

from harness import core, inputs, registry

SMALL = {
    "glm_epsilon": {"rows": 8192, "features": 64},
    "game_ml1m": {"rows": 20000, "users": 200, "items": 100,
                  "assumed": {"max_rows_per_user": 600, "max_rows_per_item": 1200,
                              "held_out_rows": 512, "d_global": 32, "d_per_entity": 8,
                              "bucket_sizes": [8, 32, 128, 512]}},
}
#: every cell file, those that BENCHMARK.json does not list yet too
CELLS = [dict(registry.cell(p.stem), name=p.stem)
         for p in sorted((registry.ROOT / "cells").glob("*.json"))]


def _run(cell, seed, **kw):
    config = registry.cell(cell)["config"]
    return core.run(cell, seed, 0.0, False, t_start=time.time(), on_card=False, device="cpu",
                    config_overrides=SMALL[config], **kw)


def _faults(cell):
    kind = registry.traffic(registry.cell(cell)["traffic"])["kind"]
    return list(registry.kind(kind).FAULTS)


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_an_unbroken_run_is_correct(cell):
    r = _run(cell, 2**31 + 101)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [(w["name"], f) for w in CELLS for f in _faults(w["name"])])
def test_a_broken_run_is_not_correct(cell, fault):
    r = _run(cell, 2**31 + 202, faults=[fault])
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS if w["config"] == "glm_epsilon"])
def test_the_tf32_reference_in_the_programs_place_is_not_correct(cell):
    import torch

    spec = registry.cell(cell)
    config = core._merged(registry.config(spec["config"]), SMALL[spec["config"]])
    traffic = registry.traffic(spec["traffic"])
    reference = registry.reference(traffic["kind"])
    for seed in (7, 8, 9):
        data = getattr(inputs, config["inputs"])(torch, config, seed, "cpu")
        answers = reference.control_answers(torch, config, traffic, data)
        checks, failed = core.judge(reference.check(torch, config, traffic, data, answers),
                                    spec["limits"])
        assert failed > 0, checks


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in CELLS
                                  if "control_traffic" in registry.traffic(w["traffic"])])
def test_the_programs_tf32_path_is_not_correct_on_the_card(card, cell):
    control = registry.traffic(registry.cell(cell)["traffic"])["control_traffic"]
    for seed in (7, 8, 9):
        config = registry.cell(cell)["config"]
        r = core.run(cell, seed, 0.0, False, t_start=time.time(), on_card=False, device=card,
                     config_overrides=SMALL[config], traffic_overrides=control)
        assert not r["correct"], r["checks"]
