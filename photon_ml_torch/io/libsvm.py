"""LibSVM text -> CSR arrays (the port's parser).

Counterpart of ``photon_ml_tpu/io/libsvm_native.py`` on its pure-Python
path; reference photon-client io/deprecated/LibSVMInputDataFormat.scala.
Conventions: 1-based indices by default (a 0 index in a 1-based file is an
error), ``#`` comments, ±1 labels mapped to {0, 1} by
:meth:`LibSVMData.mapped_labels`, any other label kept as a regression
target. The JAX package's native C++ tokenizer is host code the port does
not load (ROADMAP.md host items).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class LibSVMData:
    """CSR view of one or more LibSVM files.

    labels:      [n] float64, raw file labels
    row_offsets: [n+1] uint64
    cols:        [nnz] uint32 feature indices (0-based)
    vals:        [nnz] float64
    """

    labels: np.ndarray
    row_offsets: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def num_rows(self) -> int:
        return int(self.labels.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @property
    def max_index(self) -> int:
        """Largest 0-based feature index, -1 when there is no feature."""
        return int(self.cols.max()) if self.nnz else -1

    def row_ids(self) -> np.ndarray:
        """The row of each entry, [nnz] intp."""
        return np.repeat(np.arange(self.num_rows, dtype=np.intp),
                         np.diff(self.row_offsets).astype(np.intp))

    def mapped_labels(self) -> np.ndarray:
        """±1 binary labels -> {0, 1}; other values pass through."""
        binary = np.isin(self.labels, (-1.0, 1.0))
        return np.where(binary, (self.labels > 0).astype(np.float64), self.labels)

    def to_dense(self, num_cols: int | None = None, dtype=np.float64) -> np.ndarray:
        """[n, d] dense matrix (duplicate idx:val tokens accumulate)."""
        d = (self.max_index + 1) if num_cols is None else num_cols
        x = np.zeros((self.num_rows, d), dtype=dtype)
        keep = self.cols < d
        np.add.at(x, (self.row_ids()[keep], self.cols[keep].astype(np.intp)),
                  self.vals[keep].astype(dtype))
        return x


def parse_libsvm(path: str | os.PathLike, *, zero_based: bool = False) -> LibSVMData:
    """Parse one LibSVM file to CSR."""
    path = str(path)
    if os.path.isdir(path):
        raise IsADirectoryError(f"expected a LibSVM file, got directory: {path}")
    labels: list[float] = []
    offsets: list[int] = [0]
    cols: list[int] = []
    vals: list[float] = []
    base = 0 if zero_based else 1
    with open(path, encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break
                idx_s, sep, val_s = tok.partition(":")
                if not sep:
                    raise ValueError(f"bad feature token {tok!r} at line {line_no} in {path}")
                idx = int(idx_s) - base
                if idx < 0:
                    raise ValueError(f"feature index out of range at line {line_no} in {path}")
                cols.append(idx)
                vals.append(float(val_s))
            offsets.append(len(cols))
    return LibSVMData(
        labels=np.asarray(labels, dtype=np.float64),
        row_offsets=np.asarray(offsets, dtype=np.uint64),
        cols=np.asarray(cols, dtype=np.uint32),
        vals=np.asarray(vals, dtype=np.float64),
    )


def concat_libsvm(parts: list[LibSVMData]) -> LibSVMData:
    """Concatenate several parsed files into one CSR block."""
    if len(parts) == 1:
        return parts[0]
    labels = np.concatenate([p.labels for p in parts])
    cols = np.concatenate([p.cols for p in parts])
    vals = np.concatenate([p.vals for p in parts])
    offsets = [np.asarray([0], dtype=np.uint64)]
    base = np.uint64(0)
    for p in parts:
        offsets.append(p.row_offsets[1:] + base)
        base = base + p.row_offsets[-1]
    return LibSVMData(labels, np.concatenate(offsets), cols, vals)
