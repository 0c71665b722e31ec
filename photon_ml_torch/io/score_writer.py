"""Score output directory writer (the port's single-process writer).

Counterpart of ``photon_ml_tpu/io/score_writer.py`` with one rank: the
scores go into ``part-NNNNN.avro`` files of ``records_per_file`` records in
``write_scores``' byte layout (reference ScoreProcessingUtils.scala). The
per-rank part files of a multi-process run come with the multi-GPU slice
(ROADMAP.md item 15).
"""

from __future__ import annotations

import os

import numpy as np

from photon_ml_torch.io.model_io import write_scores


class ShardedScoreWriter:
    """Writes a score vector into a scores directory as part files."""

    def __init__(self, output_dir: str | os.PathLike):
        self.output_dir = str(output_dir)

    def write(
        self,
        scores: np.ndarray,
        *,
        model_id: str = "",
        uids: np.ndarray | None = None,
        labels: np.ndarray | None = None,
        weights: np.ndarray | None = None,
        records_per_file: int = 1 << 20,
    ) -> list[str]:
        """Write ``scores`` (+ aligned columns); returns the paths written —
        only the files this call produced, though a reused directory may
        hold stale parts of a larger earlier run."""
        write_scores(self.output_dir, scores, model_id=model_id, uids=uids, labels=labels,
                     weights=weights, records_per_file=records_per_file)
        num_parts = max(1, -(-len(scores) // records_per_file))
        return [os.path.join(self.output_dir, f"part-{i:05d}.avro") for i in range(num_parts)]
