"""glog-style logging to stderr (copy of qmf_tpu/utils/logging.py).

The reference logs everything through glog with ``FLAGS_logtostderr = 1``
(qmf/wals.cpp:57). This module gives the port one shared logger, named
``qmf_tpu_torch``, with the same glog-like line format as ``qmf_tpu``'s:
``I0816 12:34:56.789012 file.py:42] message``. Its level comes from
``QMF_TPU_LOGLEVEL``, as there.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVEL_CHAR = {
    logging.DEBUG: "D",
    logging.INFO: "I",
    logging.WARNING: "W",
    logging.ERROR: "E",
    logging.CRITICAL: "F",
}


class _GlogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        level = _LEVEL_CHAR.get(record.levelno, "I")
        ct = self.converter(record.created)
        usec = int((record.created % 1.0) * 1e6)
        prefix = (
            f"{level}{ct.tm_mon:02d}{ct.tm_mday:02d} "
            f"{ct.tm_hour:02d}:{ct.tm_min:02d}:{ct.tm_sec:02d}.{usec:06d} "
            f"{os.path.basename(record.pathname)}:{record.lineno}]"
        )
        return f"{prefix} {record.getMessage()}"


def _make_logger() -> logging.Logger:
    logger = logging.getLogger("qmf_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_GlogFormatter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("QMF_TPU_LOGLEVEL", "INFO").upper())
        logger.propagate = False
    return logger


log = _make_logger()
