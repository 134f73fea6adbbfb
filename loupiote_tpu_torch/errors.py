"""Typed errors (counterpart of ``loupiote_tpu/errors.py``)."""

from __future__ import annotations


class Error(Exception):
    """Base renderer error."""


class FileNotFound(Error):
    pass


class TextureToBufferReadFail(Error):
    pass


class AccelBuild(Error):
    pass
