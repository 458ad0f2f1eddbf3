"""Session log (reference `hail/python/hail/utils/java.py` Env.hc log +
`is/hail/utils/package.scala log`): hl.init(log=..., quiet=..., append=...)
configures a 'hail_tpu' logger writing per-stage execution records — each
map_collect stage logs its partition count and wall time, the analogue of
the reference's per-stage Spark/QoB log lines and the X-Hail-Timings tree."""

from __future__ import annotations

import logging
import os

_LOGGER_NAME = 'hail_tpu'


def configure(log_path: str, quiet: bool, append: bool) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        try:
            h.close()
        except Exception:
            pass
    try:
        d = os.path.dirname(os.path.abspath(log_path))
        os.makedirs(d, exist_ok=True)
        fh = logging.FileHandler(log_path, mode='a' if append else 'w')
        fh.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s: %(message)s', '%Y-%m-%d %H:%M:%S'))
        logger.addHandler(fh)
    except OSError:
        pass  # unwritable log path must not kill the session
    if not quiet:
        sh = logging.StreamHandler()
        sh.setLevel(logging.WARNING)
        logger.addHandler(sh)
    return logger


def logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)
