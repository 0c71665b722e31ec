"""Bench-artifact history: one loader and unit-string parser for the
``BENCH_r*.json`` / ``MULTICHIP_r*.json`` records (the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/bench_history.py``; the reference
publishes no benchmark artifacts. Each round's benchmark output is kept as
a 2,000-byte tail plus a best-effort ``parsed`` JSON object, and every
row's win criterion references values embedded in its compact unit string
(its same-run baseline). Here that chain is machine-readable:

- :func:`load_bench_artifact` reads one ``BENCH_rNN.json``; when ``parsed``
  is null it salvages the intact trailing row objects out of the truncated
  tail and flags the artifact.
- :func:`parse_unit` decodes the compact unit grammar (``ELLsr 644``,
  ``OFF710 ovl0.03``, ``v62/128 sw8/8``, ``1/dsp sr 3400``, ``0.57xcal``)
  and the older verbose prose into typed fields.
- :func:`calibration_fraction` normalizes a bandwidth row against the same
  artifact's ``fe_hot_loop_stream_gbps`` probe.
- :func:`load_history` collects every round in a directory, sorted, so
  cross-round trend analysis (``telemetry/verdicts.py``) reads one
  structure.

Everything here is stdlib-only (json/re). The artifacts are the JAX
package's benchmark records, measured on a TPU; nothing in the port writes
one.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

#: driver artifact filename patterns (repo root / run directory)
BENCH_GLOB = "BENCH_r*.json"
MULTICHIP_GLOB = "MULTICHIP_r*.json"
#: the full unslimmed report bench.py sidecars under PHOTON_TELEMETRY_DIR
SIDECAR_FILENAME = "bench-report.json"

_NUM = r"(\d+(?:\.\d+)?)"

#: field -> (regex, cast); the compact r6+ unit grammar first, then the
#: legacy verbose prose the r01-r05 artifacts carry. Each row's unit embeds
#: its OWN same-run baseline (the calibration discipline), so these fields
#: are what the verdict rules judge against.
_UNIT_PATTERNS: tuple[tuple[str, str, type], ...] = (
    # embedded same-run baselines
    ("ell_ms", rf"ELLsr {_NUM}", float),
    ("ell_unscheduled_ms", rf"ELLunsr {_NUM}", float),
    ("off_ms", rf"OFF{_NUM}", float),
    ("overlap", rf"ovl{_NUM}", float),
    ("unbatched_rate", rf"1/dsp sr {_NUM}", float),
    ("seq_rate", rf"seq{_NUM}", float),
    ("full_ms", rf"fullsr {_NUM}", float),
    ("one_rank_ms", rf"1rk{_NUM}", float),
    ("p95_ms", rf"p95 {_NUM}ms", float),
    ("cal_fraction", rf"{_NUM}xcal", float),
    # descriptive fields
    ("coverage", rf"cov{_NUM}", float),
    ("hot_cols", r"hot(\d+)", int),
    ("roofline_gbps", rf"roof{_NUM}", float),
    ("chunks", r"ON (\d+)ch", int),
    ("chunks", r"\b(\d+)ch\b", int),  # r20 trims the "ON " (line budget)
    # legacy verbose grammar (r01-r05): the same facts in prose
    ("cal_fraction", rf"stream rate: {_NUM}", float),
    ("ms_per_iter", rf"{_NUM} ?ms/it(?:er)?\b", float),
    ("ms_per_eval", rf"{_NUM} ms/eval", float),
)


def parse_unit(metric: str, unit: str) -> dict:
    """Structured fields out of one row's compact unit string.

    Tolerant by design: returns whatever the grammar yields (possibly
    empty) — a verdict rule that needs a missing field reports
    ``no-evidence`` instead of crashing on an old artifact.
    """
    out: dict = {}
    for field, pattern, cast in _UNIT_PATTERNS:
        if field in out:
            continue  # first grammar wins (compact beats legacy prose)
        m = re.search(pattern, unit)
        if m:
            out[field] = cast(m.group(1))
    # DuHL evidence pairs: v<ordered>/<uniform> visits, sw<o>/<u> sweeps
    m = re.search(r"\bv(\d+)/(\d+)", unit)
    if m:
        out["visits_ordered"] = int(m.group(1))
        out["visits_uniform"] = int(m.group(2))
    m = re.search(r"\bsw(\d+)/(\d+)", unit)
    if m:
        out["sweeps_ordered"] = int(m.group(1))
        out["sweeps_uniform"] = int(m.group(2))
    # refresh evidence pair: ln<solved>/<total> RE lane-solves
    m = re.search(r"\bln(\d+)/(\d+)", unit)
    if m:
        out["lanes_solved"] = int(m.group(1))
        out["lanes_total"] = int(m.group(2))
    # partitioned-read evidence pair: rb<max-per-rank>/<input>MB decoded
    m = re.search(r"\brb(\d+(?:\.\d+)?)/(\d+(?:\.\d+)?)MB", unit)
    if m:
        out["rank_payload_mb"] = float(m.group(1))
        out["input_mb"] = float(m.group(2))
    return out


@dataclasses.dataclass
class BenchRow:
    """One report row (primary or extra_metrics entry) + its parsed unit."""

    metric: str
    value: float | None
    spread: list
    unit: str
    parsed_unit: dict
    salvaged: bool = False

    @classmethod
    def from_report_row(cls, row: dict, *, salvaged: bool = False) -> "BenchRow":
        unit = str(row.get("unit", ""))
        value = row.get("value")
        return cls(
            metric=str(row.get("metric", "")),
            value=None if value is None else float(value),
            spread=list(row.get("spread") or []),
            unit=unit,
            parsed_unit=parse_unit(str(row.get("metric", "")), unit),
            salvaged=salvaged,
        )


@dataclasses.dataclass
class BenchArtifact:
    """One round's bench evidence: rows + capture health."""

    path: str
    round: int | None
    rc: int | None
    parsed_ok: bool        #: the captured tail's parse round-tripped
    rows: list             #: list[BenchRow] — extra_metrics (+ salvage)
    primary: "BenchRow | None" = None
    vs_baseline: float | None = None
    source: str = "parsed"  #: "parsed" | "tail-salvage" | "sidecar"
    tail_bytes: int = 0

    def row(self, metric: str) -> "BenchRow | None":
        if self.primary is not None and self.primary.metric == metric:
            return self.primary
        for r in self.rows:
            if r.metric == metric:
                return r
        return None

    @property
    def all_rows(self) -> list:
        rows = list(self.rows)
        if self.primary is not None:
            rows.insert(0, self.primary)
        return rows


def _round_of(path: str, data: dict) -> int | None:
    if isinstance(data.get("n"), int):
        return int(data["n"])
    m = re.search(r"r(\d+)\.json$", os.path.basename(path))
    return int(m.group(1)) if m else None


def salvage_rows(tail: str) -> list:
    """Recover intact row objects from a TRUNCATED tail capture.

    The tail keeps the LAST 2,000 bytes, so over-budget lines lose their
    head (the primary metric) while trailing ``{"metric": ...}`` objects
    survive whole — exactly the r04/r05 ``parsed: null`` shape. Balanced
    objects are decoded with ``json.JSONDecoder.raw_decode``; a decoded
    object that is itself a full report expands into its rows.
    """
    decoder = json.JSONDecoder()
    rows: list = []
    i = 0
    while True:
        j = tail.find('{"metric"', i)
        if j < 0:
            break
        try:
            obj, end = decoder.raw_decode(tail, j)
        except ValueError:
            i = j + 1
            continue
        i = end
        if isinstance(obj, dict) and "extra_metrics" in obj:
            # a complete report object: expand primary + rows
            rows.append(obj)
            rows.extend(obj["extra_metrics"])
        elif isinstance(obj, dict) and "metric" in obj:
            rows.append(obj)
    return rows


def load_bench_artifact(path: str) -> BenchArtifact:
    """One ``BENCH_rNN.json`` -> :class:`BenchArtifact` (salvaging the tail
    when the record holds ``parsed: null``)."""
    with open(path) as f:
        data = json.load(f)
    tail = str(data.get("tail", ""))
    parsed = data.get("parsed")
    art = BenchArtifact(
        path=path,
        round=_round_of(path, data),
        rc=data.get("rc"),
        parsed_ok=parsed is not None,
        rows=[],
        tail_bytes=len(tail.encode()),
    )
    if parsed is not None:
        art.primary = BenchRow.from_report_row(parsed)
        art.vs_baseline = parsed.get("vs_baseline")
        art.rows = [
            BenchRow.from_report_row(r)
            for r in parsed.get("extra_metrics") or []
        ]
        art.source = "parsed"
        return art
    art.source = "tail-salvage"
    seen: set[str] = set()
    for obj in salvage_rows(tail):
        if "extra_metrics" in obj:
            art.primary = BenchRow.from_report_row(obj, salvaged=True)
            art.vs_baseline = obj.get("vs_baseline")
            continue
        row = BenchRow.from_report_row(obj, salvaged=True)
        if row.metric and row.metric not in seen:
            seen.add(row.metric)
            art.rows.append(row)
    return art


def load_sidecar(path: str) -> BenchArtifact:
    """The full unslimmed ``bench-report.json`` sidecar bench.py writes
    under ``PHOTON_TELEMETRY_DIR`` — never tail-truncated, so the doctor
    prefers it over the captured line when both describe the same run."""
    with open(path) as f:
        data = json.load(f)
    report = data.get("report", data)
    art = BenchArtifact(
        path=path,
        round=data.get("round"),
        rc=0,
        parsed_ok=True,
        rows=[
            BenchRow.from_report_row(r)
            for r in report.get("extra_metrics") or []
        ],
        primary=BenchRow.from_report_row(report),
        vs_baseline=report.get("vs_baseline"),
        source="sidecar",
    )
    return art


@dataclasses.dataclass
class MultichipArtifact:
    path: str
    round: int | None
    n_devices: int | None
    rc: int | None
    ok: bool
    skipped: bool


def load_multichip_artifact(path: str) -> MultichipArtifact:
    with open(path) as f:
        data = json.load(f)
    return MultichipArtifact(
        path=path,
        round=_round_of(path, data),
        n_devices=data.get("n_devices"),
        rc=data.get("rc"),
        ok=bool(data.get("ok", data.get("rc") == 0)),
        skipped=bool(data.get("skipped", False)),
    )


@dataclasses.dataclass
class BenchHistory:
    """Every round's artifacts in one directory, sorted by round."""

    artifacts: list
    multichip: list
    sidecar: "BenchArtifact | None" = None

    @property
    def latest(self) -> "BenchArtifact | None":
        """The artifact current-run verdicts judge: the sidecar when one is
        present (always complete), else the highest round."""
        if self.sidecar is not None:
            return self.sidecar
        return self.artifacts[-1] if self.artifacts else None

    def series(self, metric: str) -> list:
        """[(round, BenchRow)] for one metric across rounds (rows missing
        from a round — including truncated-away primaries — are skipped)."""
        out = []
        for art in self.artifacts:
            row = art.row(metric)
            if row is not None and row.value is not None:
                out.append((art.round, row))
        return out


def load_history(directory: str) -> BenchHistory:
    """All bench evidence in ``directory``: BENCH_r*/MULTICHIP_r* rounds
    plus the sidecar, each loaded tolerantly (a malformed artifact becomes
    an empty round, never an exception — the doctor must read sick runs)."""
    arts = []
    for path in sorted(glob.glob(os.path.join(directory, BENCH_GLOB))):
        try:
            arts.append(load_bench_artifact(path))
        except (OSError, ValueError) as e:
            arts.append(BenchArtifact(
                path=path, round=None, rc=None, parsed_ok=False, rows=[],
                source=f"unreadable: {e}",
            ))
    arts.sort(key=lambda a: (a.round is None, a.round))
    multi = []
    for path in sorted(glob.glob(os.path.join(directory, MULTICHIP_GLOB))):
        try:
            multi.append(load_multichip_artifact(path))
        except (OSError, ValueError):
            multi.append(MultichipArtifact(
                path=path, round=None, n_devices=None, rc=None, ok=False,
                skipped=False,
            ))
    multi.sort(key=lambda a: (a.round is None, a.round))
    sidecar = None
    sidecar_path = os.path.join(directory, SIDECAR_FILENAME)
    if os.path.exists(sidecar_path):
        try:
            sidecar = load_sidecar(sidecar_path)
        except (OSError, ValueError):
            sidecar = None
    return BenchHistory(artifacts=arts, multichip=multi, sidecar=sidecar)


def calibration_fraction(artifact: BenchArtifact, row: BenchRow) -> float | None:
    """A bandwidth row as a fraction of the SAME artifact's stream probe.

    Prefers the fraction the unit already embeds (``0.57xcal`` — computed
    in-process by bench.py, immune to rounding); falls back to
    value / same-run ``fe_hot_loop_stream_gbps``. None when the artifact
    carries neither (e.g. the r02 record predates the probe row) — never a
    cross-round number (chips vary run to run).
    """
    frac = row.parsed_unit.get("cal_fraction")
    if frac is not None:
        return float(frac)
    cal = artifact.row("fe_hot_loop_stream_gbps")
    if cal is None or not cal.value or row.value is None:
        return None
    return float(row.value) / float(cal.value)
