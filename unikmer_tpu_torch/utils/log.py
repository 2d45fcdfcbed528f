"""Logger of the port (copy of unikmer_tpu/utils/log.py): the reference's
colored stderr format, `[level] message` with timestamps."""

from __future__ import annotations

import logging
import sys

_LOG_FORMAT = "%(asctime)s [%(levelname)s]\033[0m %(message)s"
_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[31m",
}


class _ColorFormatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__(_LOG_FORMAT if color else
                         "%(asctime)s [%(levelname)s] %(message)s",
                         datefmt="%H:%M:%S")
        self._color = color

    def format(self, record):
        s = super().format(record)
        if self._color:
            s = _COLORS.get(record.levelname, "") + s
        return s


log = logging.getLogger("unikmer_tpu_torch")


def init_logging(verbose: bool = False) -> None:
    if log.handlers:
        log.setLevel(logging.INFO if verbose else logging.WARNING)
        return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(_ColorFormatter(sys.stderr.isatty()))
    log.addHandler(h)
    log.setLevel(logging.INFO if verbose else logging.WARNING)


def check_error(err: BaseException | None, prefix: str = "") -> None:
    """Log an error and exit with the reference's code (-1), if any."""
    if err is not None:
        log.error(f"{prefix}{err}" if prefix else str(err))
        sys.exit(-1)


def die(msg: str) -> None:
    """Log an error and exit with the reference's code (-1)."""
    log.error(msg)
    sys.exit(-1)
