"""Job logger writing to a local file, copied to a final destination on close
(the port's own copy of ``photon_ml_tpu/util/logging_util.py``).

Reference parity: photon-lib util/PhotonLogger.scala:34-90 — an slf4j logger
that writes to a local tmp file and uploads it to HDFS when closed, with its
own level filtering. Here: a stdlib logging handler writing a local spool
file, atomically moved/copied to the requested path on ``close()`` (the
"HDFS" of this build is whatever filesystem the output dir lives on).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile


class PhotonLogger:
    """``with PhotonLogger(dest_path) as log: log.info(...)``."""

    def __init__(
        self,
        destination_path: str | os.PathLike,
        *,
        level: int = logging.INFO,
        name: str = "photon_ml_torch.job",
        capture_logger: str = "photon_ml_torch",
    ):
        """The handler attaches to ``capture_logger`` (default: the package
        root), so Timed phase durations, estimator and optimizer logging all
        land in the job log, not just messages sent through this object."""
        self.destination_path = str(destination_path)
        self._tmp = tempfile.NamedTemporaryFile(
            mode="w", suffix=".log", delete=False, prefix="photon-"
        )
        self._tmp.close()
        self._handler = logging.FileHandler(self._tmp.name)
        self._handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s - %(message)s")
        )
        self._handler.setLevel(level)
        #: (logger, level it had before attach) — restored on close, so a
        #: job log cannot permanently lower a captured logger's level
        self._attached: list[tuple[logging.Logger, int]] = []

        def attach(lg: logging.Logger) -> None:
            prior_level = lg.level
            if lg.level == logging.NOTSET or lg.level > level:
                lg.setLevel(level)
            lg.addHandler(self._handler)
            self._attached.append((lg, prior_level))

        attach(logging.getLogger(capture_logger))
        self.logger = logging.getLogger(name)
        if name != capture_logger and not name.startswith(capture_logger + "."):
            attach(self.logger)  # messages via this object still reach the file
        self._closed = False

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for lg, prior_level in self._attached:
            lg.removeHandler(self._handler)
            lg.setLevel(prior_level)
        self._handler.close()
        os.makedirs(os.path.dirname(self.destination_path) or ".", exist_ok=True)
        shutil.copyfile(self._tmp.name, self.destination_path)
        os.unlink(self._tmp.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
