"""The port's bench history (``photon_ml_torch/telemetry/bench_history.py``)
against the JAX package's, on the CPU, over artifacts the tests write to a
temporary directory: unit parsing, tail salvage, the artifact, sidecar and
multichip loaders, the history and the calibration fraction are equal.
"""

import dataclasses
import json

import numpy as np
import pytest

import bench  # the JAX package's benchmark rows (no jax at import)
from photon_ml_torch.telemetry import bench_history as tb
from photon_ml_tpu.telemetry import bench_history as jb

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _report(seed: int) -> dict:
    """bench.sample_report() with every row's value and spread drawn from a
    seed (the units, which embed each row's same-run baseline, kept)."""
    r = np.random.default_rng(seed)
    report = bench.sample_report()

    def draw(row):
        v = float(np.round(r.uniform(0.1, 2000.0), 3))
        row["value"], row["spread"] = v, [round(v * 0.97, 3), round(v * 1.02, 3)]

    draw(report)
    for row in report["extra_metrics"]:
        draw(row)
    return report


def write_history(d, *, rounds=(1, 2, 3), salvage_round=4, multichip=(1, 2, 3),
                  sidecar=True):
    """BENCH_rNN.json rounds (one with ``parsed: null`` and a 2,000-byte
    tail), MULTICHIP_rNN.json rounds (ok, failed, skipped) and a sidecar,
    written into ``d``."""
    for n in rounds:
        report = _report(n)
        (d / f"BENCH_r{n:02d}.json").write_text(json.dumps(
            {"n": n, "cmd": "python bench.py", "rc": 0, "tail": json.dumps(report)[-2000:],
             "parsed": report}))
    if salvage_round is not None:
        report = _report(salvage_round)
        (d / f"BENCH_r{salvage_round:02d}.json").write_text(json.dumps(
            {"n": salvage_round, "cmd": "python bench.py", "rc": 0,
             "tail": json.dumps(report)[-2000:], "parsed": None}))
    for i, n in enumerate(multichip):
        (d / f"MULTICHIP_r{n:02d}.json").write_text(json.dumps(
            {"n": n, "n_devices": 4, "rc": [0, 1, 0][i % 3], "ok": [True, False, True][i % 3],
             "skipped": i % 3 == 2, "tail": ""}))
    if sidecar:
        (d / tb.SIDECAR_FILENAME).write_text(json.dumps({"round": 9, "report": _report(9)}))
    (d / "BENCH_r05.json").write_text("{not json")


def _plain(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def test_parse_unit_matches_on_every_sample_row():
    report = bench.sample_report()
    rows = [report] + report["extra_metrics"]
    assert len(rows) > 10
    for row in rows:
        assert tb.parse_unit(row["metric"], row["unit"]) == \
            jb.parse_unit(row["metric"], row["unit"])
    for metric, unit in (("x", "ELLsr 644 OFF710 ovl0.03 v62/128 sw8/8"),
                         ("y", "1/dsp sr 3400 0.57xcal p95 12.5ms"),
                         ("z", "stream rate: 0.9 of 700 GB/s, 3.2 ms/iter"), ("w", "")):
        assert tb.parse_unit(metric, unit) == jb.parse_unit(metric, unit)


def test_salvage_rows_matches():
    report = _report(4)
    tail = json.dumps(report)[-2000:]
    assert tb.salvage_rows(tail) == jb.salvage_rows(tail)
    whole = json.dumps(report)
    assert tb.salvage_rows(whole) == jb.salvage_rows(whole)


def test_loaders_and_history_match(tmp_path):
    write_history(tmp_path)
    for name in ("BENCH_r01.json", "BENCH_r04.json"):
        t = tb.load_bench_artifact(str(tmp_path / name))
        j = jb.load_bench_artifact(str(tmp_path / name))
        assert _plain(t) == _plain(j)
    assert _plain(tb.load_sidecar(str(tmp_path / tb.SIDECAR_FILENAME))) == \
        _plain(jb.load_sidecar(str(tmp_path / jb.SIDECAR_FILENAME)))
    assert _plain(tb.load_multichip_artifact(str(tmp_path / "MULTICHIP_r02.json"))) == \
        _plain(jb.load_multichip_artifact(str(tmp_path / "MULTICHIP_r02.json")))
    th, jh = tb.load_history(str(tmp_path)), jb.load_history(str(tmp_path))
    assert _plain(th) == _plain(jh)
    assert [a.round for a in th.artifacts] == [1, 2, 3, 4, None]
    assert th.artifacts[3].source == "tail-salvage" and th.latest.source == "sidecar"
    assert [_plain(r) for _, r in th.series("fe_hot_loop_stream_gbps")] == \
        [_plain(r) for _, r in jh.series("fe_hot_loop_stream_gbps")]
    for tart, jart in zip(th.artifacts, jh.artifacts):
        for trow, jrow in zip(tart.all_rows, jart.all_rows):
            assert tb.calibration_fraction(tart, trow) == jb.calibration_fraction(jart, jrow)


def test_empty_directory_matches(tmp_path):
    assert _plain(tb.load_history(str(tmp_path))) == _plain(jb.load_history(str(tmp_path)))
    assert tb.load_history(str(tmp_path)).latest is None


@pytest.mark.parametrize("name", ["BENCH_GLOB", "MULTICHIP_GLOB", "SIDECAR_FILENAME"])
def test_names_match(name):
    assert getattr(tb, name) == getattr(jb, name)
