"""The framework logger (the port's own copy of ``get_logger`` of
``torchdistx_tpu/utils/logging.py``): one ``torchdistx_tpu_torch``
logger writing to stderr at the configured level (``TDX_LOG_LEVEL``).
The JAX module's deprecated ``Metrics`` shim has no counterpart: the
port's step records go through :mod:`..observe`."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("torchdistx_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            )
            logger.addHandler(h)
            logger.propagate = False  # avoid double emit via root handlers
            from .. import config

            logger.setLevel(config.get().log_level)
        _LOGGER = logger
    return _LOGGER
