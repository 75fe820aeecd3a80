"""Logging helpers (single place so launchers can reconfigure); port of
:mod:`repro.utils.logging`."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("REPRO_LOGLEVEL", "INFO").upper()
        logging.basicConfig(stream=sys.stderr, level=level, format=_FORMAT, datefmt="%H:%M:%S")
        _configured = True
    return logging.getLogger(name)
