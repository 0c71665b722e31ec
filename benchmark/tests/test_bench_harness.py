"""The harness on the CPU: finding pieces by name, the window arithmetic, the
judging of answers against limits, the roofline counts, the trace's
reading and the import check."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from harness import core, imports, inputs, registry, roofline, trace

BENCH = json.loads(registry.SPEC.read_text())


def test_every_entry_of_the_spec_is_found_by_name():
    for c in BENCH["configs"]:
        config = registry.config(c["name"])
        assert Path(c["file"]) == (registry.ROOT / "configs" / f"{c['name']}.json").relative_to(
            registry.CHECKOUT)
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        kind = registry.traffic(cell["traffic"])["kind"]
        assert hasattr(registry.kind(kind), "run_unit")
        assert hasattr(registry.reference(kind), "check")
    for m in BENCH["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in registry.metrics_of(cell, "end_to_end", BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = registry.metrics_of(cell, "per_layer", BENCH)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_an_unknown_name_is_refused():
    with pytest.raises(LookupError, match="no cell named 'nope'"):
        registry.cell("nope")
    with pytest.raises(LookupError):
        registry.metric("nope.glm")


class _Sleeper:
    """A kind whose unit takes ``unit_s`` and counts one solve."""

    def __init__(self, unit_s):
        self.unit_s, self.calls = unit_s, 0

    def run_unit(self, torch, state):
        self.calls += 1
        time.sleep(self.unit_s)
        return {"solves": 1, "iterations": 3}


def test_the_window_counts_whole_units_and_starts_none_after_its_seconds():
    kind = _Sleeper(0.04)
    counts, wall = core.window(None, kind, {}, 0.1, lambda: None)
    assert counts == {"solves": kind.calls, "iterations": 3 * kind.calls}
    # the unit that crossed 0.1 s is the last one, and it is whole
    assert kind.calls == 3 and 0.1 <= wall < 0.1 + 0.04 + 0.03
    assert wall / counts["solves"] == pytest.approx(wall / 3)


def test_the_window_runs_at_least_one_unit():
    kind = _Sleeper(0.0)
    counts, _ = core.window(None, kind, {}, 0.0, lambda: None)
    assert counts["solves"] == 1


def test_judge_takes_the_widest_reading_and_counts_answers_over_a_limit():
    checks, failed = core.judge([{"a": 1e-6, "b": 2.0}, {"a": 3e-6, "b": 0.5}],
                                {"a": 2e-6, "b": 1.0})
    assert checks == {"a": {"value": 3e-6, "limit": 2e-6}, "b": {"value": 2.0, "limit": 1.0}}
    assert failed == 2
    assert core.judge([{"a": float("nan")}], {"a": 1.0})[1] == 1
    with pytest.raises(KeyError, match="no limit"):
        core.judge([{"c": 0.0}], {"a": 1.0})


def test_roofline_counts_of_b1_at_epsilon():
    n, d = 400000, 2000
    nbytes, flops = roofline.glm_evaluation(n, d)
    assert nbytes == n * d * 4 + 12 * n + 8 * d + 4
    assert flops == 4 * n * d
    seconds, by = roofline.least_seconds(nbytes, flops)
    assert by == "bytes" and seconds == pytest.approx(nbytes / 3.35e12)
    assert roofline.least_seconds(1.0, 67e12)[1] == "operations"
    hv_bytes, hv_flops = roofline.hessian_vector(n, d)
    assert hv_bytes == n * d * 4 + 4 * n + 8 * d and hv_flops == 4 * n * d
    work = roofline.glm_work_seconds(n, d, evaluations=3, values=1, hvps=2)
    assert work == pytest.approx(3 * seconds + roofline.least_seconds(*roofline.glm_value(n, d))[0]
                                 + 2 * hv_bytes / 3.35e12)


def test_trace_union_idle_gaps_and_names():
    tr = trace.Trace(intervals=[("void k1<float>(int)", 0, 100), ("k2", 50, 100),
                                ("Memcpy DtoH", 300, 50), ("k1(x)", 400, 100)],
                     window_s=1e-6)
    assert tr.busy_s() == pytest.approx(300e-9)
    assert [iv[0] for iv in tr.kernels] == ["void k1<float>(int)", "k2", "k1(x)"]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(200e-9)]
    assert b["idle_gaps"] == [["k2 -> Memcpy DtoH", pytest.approx(150e-9)],
                              ["Memcpy DtoH -> k1", pytest.approx(50e-9)]]
    assert trace.short_name("void at::native::kernel<4, f<float>>(int, float*)") == \
        "at::native::kernel"


def test_metric_readers_on_a_synthetic_trace():
    tr = trace.Trace(intervals=[("fused_glm_partials_kernel<float>", 0, 1_000_000),
                                ("reduce_partials_kernel", 1_000_000, 10_000),
                                ("fused_glm_partials_kernel<float>", 3_000_000, 1_000_000),
                                ("reduce_partials_kernel", 4_000_000, 10_000)],
                     window_s=0.01)
    ctx = {"trace": tr, "wall_s": 0.01, "shapes": {"n": 400000, "d": 2000},
           "traffic": {"optimizer": "LBFGS"},
           "counts": {"solves": 2, "iterations": 10, "evaluations": 2, "values": 0, "hvps": 0,
                      "b1_launches": 2}}
    least = roofline.least_seconds(*roofline.glm_evaluation(400000, 2000))[0]
    assert registry.metric("b1_roofline.glm").read(ctx) == pytest.approx(least / 1.01e-3 * 100)
    assert registry.metric("iters_per_lambda.glm").read(ctx) == 5
    assert registry.metric("device_idle.glm").read(ctx) == pytest.approx(100 * (1 - 2.02e-3 / 0.01))
    host_ms = (0.01 - 2.02e-3) / 10 * 1e3
    assert registry.metric("solver_host_ms.glm").read(ctx) == pytest.approx(host_ms)
    assert registry.metric("mfu.glm").read(ctx) == pytest.approx(2 * least / 0.01 * 100)
    mfu = registry.metric("mfu.glm")
    for short in (dict(ctx, counts=dict(ctx["counts"], b1_launches=3)),
                  dict(ctx, counts=dict(ctx["counts"], evaluations=0, b1_launches=0)),
                  dict(ctx, traffic={"optimizer": "TRON"})):
        with pytest.raises(mfu.ShortCount):
            mfu.read(short)
    tron = dict(ctx, traffic={"optimizer": "TRON"}, counts=dict(ctx["counts"], hvps=4))
    assert mfu.read(tron) > mfu.read(ctx)
    none = dict(ctx, trace=trace.Trace(intervals=[("other", 0, 5)], window_s=0.01))
    assert registry.metric("b1_roofline.glm").read(none) is None
    game = {"trace": tr, "counts": {"sweeps": 4, "lane_host_reads": 40}}
    assert registry.metric("kernels_per_sweep.game").read(game) == 1
    assert registry.metric("lane_host_reads_per_sweep.game").read(game) == 10


def test_forbidden_modules_are_compared_by_whole_top_level_names():
    assert imports.forbidden_loaded(["photon_ml_torch.ops", "jaxtyping", "numpy"]) == []
    assert imports.forbidden_loaded(["photon_ml_tpu.ops.x", "jaxlib.xla", "jax", "flax"]) == \
        ["flax", "jax", "jaxlib", "photon_ml_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole small run of each kind in a fresh process: no module of JAX or
    of the JAX package is loaded."""
    code = f"""
import sys
sys.path[:0] = [{str(registry.ROOT)!r}, {str(registry.CHECKOUT)!r}]
from harness import core, imports
small = {{"glm_epsilon-lbfgs": {{"rows": 512, "features": 16}},
         "game_ml1m-lbfgs": {{"rows": 3000, "users": 60, "items": 40, "min_rows_per_user": 20,
                             "assumed": {{"max_rows_per_user": 200, "max_rows_per_item": 400,
                                         "held_out_rows": 64, "d_global": 8,
                                         "d_per_entity": 4}}}}}}
for cell, over in small.items():
    core.run(cell, 5, 0.0, False, t_start=0.0, on_card=False, device="cpu",
             config_overrides=over)
print(imports.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, str(registry.ROOT / "run.py"), "--workload",
                          "glm_epsilon-lbfgs", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_new_cell_config_kind_and_metric_are_files_and_entries_only(tmp_path):
    """In a copy of the benchmark, a configuration, a traffic kind with its
    mix and reference, a cell and a per-layer metric are added as new files
    and new ``BENCHMARK.json`` entries; the copy's harness finds and runs
    them, and no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.ROOT, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(registry.SPEC.read_text())
    b = root / "benchmark"
    (b / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "source": "https://example.org/toy", "reduced": [], "assumed": {},
         "rows": 10}))
    (b / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"kind": "toy_kind", "trace_units": 1, "step": 3}))
    (b / "traffic" / "toy_kind.py").write_text(
        "def end_to_end(wall_s, counts):\n    return {'toy_s': wall_s / counts['steps']}\n"
        "def setup(torch, config, traffic, seed, device, stack):\n"
        "    return {'inputs': {'rows': config['rows']}, 'shapes': {}, 'step': traffic['step']}\n"
        "def run_unit(torch, state):\n    return {'steps': state['step']}\n"
        "def answers(torch, state):\n    return [state['inputs']['rows']]\n"
        "def release(state):\n    pass\n"
        "FAULTS = {}\n")
    (b / "reference" / "toy_kind.py").write_text(
        "def check(torch, config, traffic, inputs, answers):\n"
        "    return [{'toy_gap': abs(a - config['rows'])} for a in answers]\n")
    (b / "metrics" / "toy_steps.toy.py").write_text(
        "def read(ctx):\n    return ctx['counts']['steps']\n")
    (b / "cells" / "toy-cell.json").write_text(json.dumps(
        {"config": "toy", "traffic": "toy_mix", "chips": 1, "limits": {"toy_gap": 0}}))
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy_mix",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "toy_s", "unit": "s", "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": ["toy-cell"]})
    bench["per_layer"].append({"name": "toy_steps.toy", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "toy", "moves": "toy_s",
                               "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, sys
sys.path[:0] = [sys.argv[1]]
from harness import core, registry
r = core.run("toy-cell", 1, 0.05, False, t_start=0.0, on_card=False, device="cpu")
m = registry.metric("toy_steps.toy").read({"counts": r["counts"]})
print(json.dumps({"names": sorted(r["metrics"]), "correct": r["correct"], "steps": m}))
"""
    out = subprocess.run([sys.executable, "-c", code, str(b)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["names"] == ["setup_s", "toy_s"] and got["correct"] is True
    assert got["steps"] % 3 == 0 and got["steps"] > 0
    assert all(p.read_bytes() == data for p, data in before.items())


def test_movielens_counts_are_the_published_ones_and_the_same_for_every_seed():
    cfg = registry.config("game_ml1m")
    a = cfg["assumed"]
    users = inputs.zipf_counts(cfg["rows"], cfg["users"], cfg["min_rows_per_user"],
                               a["max_rows_per_user"])
    items = inputs.zipf_counts(cfg["rows"], cfg["items"], a["min_rows_per_item"],
                               a["max_rows_per_item"])
    assert users.sum() == items.sum() == 1000209
    assert (users.min(), users.max(), items.min(), items.max()) == (20, 2314, 1, 3428)
    assert users.mean() == pytest.approx(165.6, abs=0.05)
    assert items.mean() == pytest.approx(269.9, abs=0.05)
    # heavy-tailed: the busiest tenth of users hold far more than a tenth of the rows
    assert users[: len(users) // 10].sum() > 0.25 * users.sum()


def test_inputs_repeat_for_a_seed_and_keep_their_sizes_across_seeds():
    import torch

    cfg = dict(registry.config("game_ml1m"), rows=3000, users=60, items=40)
    cfg["assumed"] = dict(cfg["assumed"], max_rows_per_user=200, max_rows_per_item=400,
                          held_out_rows=64, d_global=8, d_per_entity=4)
    big = 2**31 + 977
    a = inputs.movielens_game(torch, cfg, big, "cpu")
    b = inputs.movielens_game(torch, cfg, big, "cpu")
    c = inputs.movielens_game(torch, cfg, 3, "cpu")
    assert torch.equal(a["train"]["x_fe"], b["train"]["x_fe"])
    assert not torch.equal(a["train"]["x_fe"], c["train"]["x_fe"])
    for x, y in ((a, c),):
        for t in ("user", "item"):
            cx = torch.bincount(x["train"][t]).sort().values
            cy = torch.bincount(y["train"][t]).sort().values
            assert torch.equal(cx, cy)
    held = a["held_out"]["user"]
    assert int((held >= cfg["users"]).sum()) == 16
    eps = dict(registry.config("glm_epsilon"), rows=300, features=20)
    e = inputs.epsilon(torch, eps, big, "cpu")
    assert torch.allclose(torch.linalg.vector_norm(e["x"], dim=1), torch.ones(300), atol=1e-5)
    assert set(e["y"].unique().tolist()) <= {0.0, 1.0}
