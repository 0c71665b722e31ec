"""Score output: every rank writes its own part file.

Counterpart of ``photon_ml_tpu/io/score_writer.py``; reference photon-client
ScoreProcessingUtils.scala (each executor task writes its own part-NNNNN
file of ScoringResultAvro into the shared directory; the driver only creates
the directory).

``ShardedScoreWriter`` with an exchange of several ranks: rank 0 creates the
directory (clearing a larger earlier run's parts), a barrier publishes it,
then each rank writes only its own scores as ``part-{rank:05d}.avro``.
Because a partitioned read's blocks keep the full read's row order, the
parts in file-name order hold the one-rank writer's records in order. With
no exchange, or one rank, the output is ``write_scores``' layout byte for
byte.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from photon_ml_torch.io.model_io import write_scores
from photon_ml_torch.telemetry import io_counters

logger = logging.getLogger(__name__)


class ShardedScoreWriter:
    """Writes one rank's scores into a shared scores directory.

    exchange: a ``parallel/multihost.MetadataExchange``. None is the
    one-rank writer whatever the topology: sharded writing is asked for
    with an exchange (``default_exchange()``), as the reader's partitioning
    is.
    """

    def __init__(self, output_dir: str | os.PathLike, *, exchange=None):
        if exchange is None:
            from photon_ml_torch.parallel.multihost import SingleProcessExchange

            exchange = SingleProcessExchange()
        self.exchange = exchange
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
        """Write this rank's ``scores`` (+ aligned columns); returns the paths
        written. One rank keeps ``write_scores``' layout (part files of
        ``records_per_file``; only the files this call produced are
        returned, though a reused directory may hold stale parts); several
        ranks write exactly ``part-{rank:05d}.avro`` each."""
        ex = self.exchange
        if ex.num_ranks == 1:
            write_scores(self.output_dir, scores, model_id=model_id, uids=uids, labels=labels,
                         weights=weights, records_per_file=records_per_file)
            num_parts = max(1, -(-len(scores) // records_per_file))
            paths = [os.path.join(self.output_dir, f"part-{i:05d}.avro")
                     for i in range(num_parts)]
            io_counters.record_score_bytes_written(sum(os.path.getsize(p) for p in paths))
            return paths
        if ex.rank == 0:
            os.makedirs(self.output_dir, exist_ok=True)
            # a larger earlier run's parts would ride along with any reader
            # that concatenates the parts in order: rank 0 clears them
            for name in os.listdir(self.output_dir):
                if name.startswith("part-") and name.endswith(".avro"):
                    os.unlink(os.path.join(self.output_dir, name))
        ex.barrier("score_writer/dir")
        part = os.path.join(self.output_dir, f"part-{ex.rank:05d}.avro")
        write_scores(part, scores, model_id=model_id, uids=uids, labels=labels,
                     weights=weights)
        written = os.path.getsize(part)
        io_counters.record_score_bytes_written(written)
        logger.info("rank %d/%d wrote %d scores (%d bytes) to %s", ex.rank, ex.num_ranks,
                    len(scores), written, part)
        return [part]
