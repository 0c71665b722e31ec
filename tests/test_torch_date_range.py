"""The port's date ranges (``photon_ml_torch/util/date_range.py``) against the
JAX package's: every case of ``tests/test_date_range.py``, each result equal
to the JAX function's on the same input, errors raised alike."""

import datetime
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.util import date_range as jdr
from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
from photon_ml_torch.util import date_range as tdr


@pytest.mark.parametrize("spec", ["20260101-20260103", "20251230-20260102", "20240228-20240301"])
def test_date_range_parse_and_dates(spec):
    r, j = tdr.DateRange.parse(spec), jdr.DateRange.parse(spec)
    assert r.dates() == j.dates() and str(r) == str(j) == spec
    assert (r.start, r.end) == (j.start, j.end)


def test_date_range_rejects_what_the_reference_rejects():
    assert [d.day for d in tdr.DateRange.parse("20260101-20260103").dates()] == [1, 2, 3]
    for mod in (tdr, jdr):
        with pytest.raises(ValueError, match="after end"):
            mod.DateRange.parse("20260105-20260101")
        with pytest.raises(ValueError, match="bad date range"):
            mod.DateRange.parse("2026-01-01")


def test_days_range_to_date_range():
    today = datetime.date(2026, 7, 29)
    r = tdr.DaysRange.parse("3-1").to_date_range(today)
    assert r.start == datetime.date(2026, 7, 26) and r.end == datetime.date(2026, 7, 28)
    j = jdr.DaysRange.parse("3-1").to_date_range(today)
    assert (r.start, r.end) == (j.start, j.end)
    for mod in (tdr, jdr):
        with pytest.raises(ValueError, match="further in the past"):
            mod.DaysRange.parse("1-3")
        with pytest.raises(ValueError, match="bad days range"):
            mod.DaysRange.parse("x-3")
    # the dispatcher takes both grammars
    assert tdr.parse_date_or_days_range("20260101-20260102").start.year == 2026
    assert tdr.parse_date_or_days_range("3-1", today).end == datetime.date(2026, 7, 28)
    assert tdr.parse_date_or_days_range("0-0").start == datetime.date.today()


def test_resolve_input_paths(tmp_path):
    r = tdr.DateRange.parse("20260101-20260104")
    for day in (1, 3):
        os.makedirs(tdr.daily_path(tmp_path, datetime.date(2026, 1, day)))
    got = tdr.resolve_input_paths([tmp_path], r)
    assert [p[-2:] for p in got] == ["01", "03"]
    assert got == jdr.resolve_input_paths([tmp_path], jdr.DateRange.parse("20260101-20260104"))
    assert tdr.daily_path(tmp_path, datetime.date(2026, 1, 3)) == \
        jdr.daily_path(tmp_path, datetime.date(2026, 1, 3))
    assert tdr.resolve_input_paths([tmp_path]) == [str(tmp_path)]
    with pytest.raises(FileNotFoundError, match="no daily input"):
        tdr.resolve_input_paths([tmp_path], tdr.DateRange.parse("20270101-20270102"))
    assert tdr.resolve_input_paths([tmp_path], tdr.DateRange.parse("20270101-20270102"),
                                   error_on_missing=False) == []


def _write_libsvm(path, rows, d=3, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            feats = " ".join(f"{j + 1}:{rng.normal():.4f}" for j in range(d))
            f.write(f"{int(rng.uniform() < 0.5)} {feats}\n")


def test_read_merged_multiple_paths(tmp_path):
    _write_libsvm(tmp_path / "a.libsvm", 5, seed=1)
    _write_libsvm(tmp_path / "b.libsvm", 7, seed=2)
    shards = {"g": FeatureShardConfiguration(feature_bags=("default",))}
    both = read_merged([tmp_path / "a.libsvm", tmp_path / "b.libsvm"], shards, fmt="libsvm",
                       device="cpu")
    assert both.dataset.num_samples == 12
    one = read_merged(tmp_path / "a.libsvm", shards, fmt="libsvm", device="cpu")
    assert one.dataset.num_samples == 5
    assert torch.equal(both.dataset.labels[:5], one.dataset.labels)
    with pytest.raises(ValueError, match="at least one input path"):
        read_merged([], shards, fmt="libsvm", device="cpu")
