"""Structured logging with a consistent prefix (a copy of the JAX
package's ``repro.utils.logging``, on the ``repro_torch`` logger)."""
from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "repro_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname).1s] %(message)s", "%H:%M:%S")
        )
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)
