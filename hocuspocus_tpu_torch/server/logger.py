"""Internal logging for the server core (errors go to the std logger)."""

from __future__ import annotations

import logging

logger = logging.getLogger("hocuspocus_tpu_torch")


def log_error(message: str, *args: object) -> None:
    logger.error(message, *args)
