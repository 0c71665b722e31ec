"""Date-range parsing and date-partitioned input path resolution (the port's copy).

Counterpart of ``photon_ml_tpu/util/date_range.py``, the same functions.
Reference parity: photon-client util/DateRange.scala ("yyyyMMdd-yyyyMMdd"
ranges), util/DaysRange.scala ("N-M" days-ago ranges, converted to a
DateRange relative to today), and IOUtils.getInputPathsWithinDateRange —
resolving `<base>/daily/yyyy/MM/dd` directories inside a range, erroring
when no data exists.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Sequence

_DATE_FMT = "%Y%m%d"
_RANGE_RE = re.compile(r"^(\d{8})-(\d{8})$")
_DAYS_RE = re.compile(r"^(\d+)-(\d+)$")


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] date range (reference DateRange.scala)."""

    start: datetime.date
    end: datetime.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"invalid date range: start {self.start} is after end {self.end}"
            )

    @classmethod
    def parse(cls, spec: str) -> "DateRange":
        """Parse "yyyyMMdd-yyyyMMdd"."""
        m = _RANGE_RE.match(spec.strip())
        if not m:
            raise ValueError(
                f"bad date range {spec!r}; expected yyyyMMdd-yyyyMMdd"
            )
        return cls(
            start=datetime.datetime.strptime(m.group(1), _DATE_FMT).date(),
            end=datetime.datetime.strptime(m.group(2), _DATE_FMT).date(),
        )

    def dates(self) -> list[datetime.date]:
        n = (self.end - self.start).days + 1
        return [self.start + datetime.timedelta(days=i) for i in range(n)]

    def __str__(self) -> str:
        return f"{self.start.strftime(_DATE_FMT)}-{self.end.strftime(_DATE_FMT)}"


@dataclasses.dataclass(frozen=True)
class DaysRange:
    """"start-end" days ago, start >= end (reference DaysRange.scala:
    '90-1' = from 90 days ago until yesterday)."""

    start_days_ago: int
    end_days_ago: int

    def __post_init__(self):
        if self.start_days_ago < self.end_days_ago:
            raise ValueError(
                "days range start must be further in the past than end: "
                f"{self.start_days_ago}-{self.end_days_ago}"
            )

    @classmethod
    def parse(cls, spec: str) -> "DaysRange":
        m = _DAYS_RE.match(spec.strip())
        if not m:
            raise ValueError(f"bad days range {spec!r}; expected N-M")
        return cls(start_days_ago=int(m.group(1)), end_days_ago=int(m.group(2)))

    def to_date_range(self, today: datetime.date | None = None) -> DateRange:
        today = today or datetime.date.today()
        return DateRange(
            start=today - datetime.timedelta(days=self.start_days_ago),
            end=today - datetime.timedelta(days=self.end_days_ago),
        )


def parse_date_or_days_range(
    spec: str, today: datetime.date | None = None
) -> DateRange:
    """Accept either grammar (drivers take both, reference GameDriver)."""
    if _RANGE_RE.match(spec.strip()):
        return DateRange.parse(spec)
    return DaysRange.parse(spec).to_date_range(today)


def daily_path(base: str | os.PathLike, date: datetime.date) -> str:
    """`<base>/daily/yyyy/MM/dd` (reference IOUtils daily dir layout)."""
    return os.path.join(str(base), "daily", f"{date.year:04d}", f"{date.month:02d}", f"{date.day:02d}")


def resolve_input_paths(
    base_paths: Sequence[str | os.PathLike],
    date_range: DateRange | None = None,
    *,
    error_on_missing: bool = True,
) -> list[str]:
    """Expand base paths into concrete data directories.

    Without a range: the base paths themselves. With one: every existing
    `<base>/daily/yyyy/MM/dd` within the range (reference
    IOUtils.getInputPathsWithinDateRange; raises when nothing exists).
    """
    if date_range is None:
        return [str(p) for p in base_paths]
    out: list[str] = []
    for base in base_paths:
        out.extend(
            p for d in date_range.dates() if os.path.isdir(p := daily_path(base, d))
        )
    if not out and error_on_missing:
        raise FileNotFoundError(
            f"no daily input directories found under {list(map(str, base_paths))} "
            f"within {date_range}"
        )
    return out
