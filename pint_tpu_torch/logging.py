"""Logging setup (reference: src/pint/logging.py, which configures
loguru — not present in this stack, so this configures the stdlib
logging module with the same ergonomics: one-call setup, level
filtering, repeated-message dedup, and warnings capture)."""

from __future__ import annotations

import logging
import sys
import warnings
from typing import Optional

__all__ = ["setup", "log", "DedupFilter"]

log = logging.getLogger("pint_tpu_torch")


class DedupFilter(logging.Filter):
    """Suppress exact-duplicate log messages after the first
    ``max_repeats`` occurrences (reference: pint.logging's
    onlyonce/dedup machinery)."""

    def __init__(self, max_repeats: int = 1):
        super().__init__()
        self.max_repeats = max_repeats
        self._counts: dict = {}

    def filter(self, record: logging.LogRecord) -> bool:
        key = (record.levelno, record.getMessage())
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        return n < self.max_repeats


_state = {"handler": None, "showwarning": None}


def setup(level: str = "INFO", sink=None, dedup: bool = True,
          capture_warnings: bool = True,
          fmt: Optional[str] = None) -> logging.Logger:
    """Configure the pint_tpu_torch logger (reference: pint.logging.setup).
    Returns the logger; safe to call repeatedly."""
    if _state["handler"] is not None:
        log.removeHandler(_state["handler"])
    handler = logging.StreamHandler(sink or sys.stderr)
    handler.setFormatter(logging.Formatter(
        fmt or "%(asctime)s %(levelname)-7s %(name)s: %(message)s",
        datefmt="%H:%M:%S"))
    if dedup:
        handler.addFilter(DedupFilter())
    log.addHandler(handler)
    log.setLevel(getattr(logging, level.upper()))
    log.propagate = False
    _state["handler"] = handler
    if capture_warnings and _state["showwarning"] is None:
        _state["showwarning"] = warnings.showwarning

        def showwarning(message, category, filename, lineno,
                        file=None, line=None):
            log.warning("%s: %s", category.__name__, message)

        warnings.showwarning = showwarning
    return log
