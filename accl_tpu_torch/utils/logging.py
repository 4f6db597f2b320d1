"""Leveled logger (counterpart: ``accl_tpu/utils/logging.py``).

Records go to the ``accl_tpu_torch`` logger tree with a
``[LEVEL name pN]`` prefix, ``pN`` taken from ``ACCL_PROC_ID`` when a
launcher sets it. ``ACCL_LOG_LEVEL`` is re-read on every
:func:`get_logger` call and applied when it changed, so an explicit
:func:`set_log_level` survives an unchanged environment.
"""
from __future__ import annotations

import logging
import os

_LOGGER_NAME = "accl_tpu_torch"
_UNREAD = object()
_seen_env: object = _UNREAD


class _ContextFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        proc = os.environ.get("ACCL_PROC_ID")
        record.accl_ctx = f" p{proc}" if proc is not None else ""
        return True


def get_logger(child: str | None = None) -> logging.Logger:
    name = _LOGGER_NAME if child is None else f"{_LOGGER_NAME}.{child}"
    logger = logging.getLogger(name)
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(levelname)s %(name)s%(accl_ctx)s] %(message)s"))
        handler.addFilter(_ContextFilter())
        root.addHandler(handler)
    global _seen_env
    env_val = os.environ.get("ACCL_LOG_LEVEL")
    if env_val != _seen_env:
        _seen_env = env_val
        try:
            root.setLevel((env_val or "WARNING").upper())
        except ValueError:
            root.setLevel("WARNING")
    return logger


def set_log_level(level: str) -> None:
    logging.getLogger(_LOGGER_NAME).setLevel(level.upper())
