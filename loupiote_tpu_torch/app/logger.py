"""Logging shim (counterpart of ``loupiote_tpu/app/logger.py``): a thin
wrapper over Python logging with a renderer-tagged logger.
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("loupiote_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[loupiote] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def log(msg: str, *args) -> None:
    _logger.info(msg, *args)


def get_logger() -> logging.Logger:
    return _logger
