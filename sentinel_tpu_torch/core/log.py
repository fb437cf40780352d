"""Record log (the port's copy of ``sentinel_tpu/core/log.py``, the analog of ``sentinel-core/.../log/RecordLog.java``).

The reference writes an internal file-based record log with a pluggable SPI
(slf4j bridge in ``sentinel-logging``). Here: a stdlib logger named
``sentinel_tpu_torch`` writing to ``$SENTINEL_LOG_DIR`` (default ``~/logs/csp`` like
the reference's ``LogBase``) when file logging is enabled, else stderr.
"""

from __future__ import annotations

import logging
import os

_LOGGER_NAME = "sentinel_tpu_torch"


def _build_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    log_dir = os.environ.get("SENTINEL_LOG_DIR")
    handler: logging.Handler
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handler = logging.FileHandler(os.path.join(log_dir, "sentinel-record.log"))
    else:
        handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
    )
    logger.addHandler(handler)
    logger.propagate = False
    return logger


record_log = _build_logger()
