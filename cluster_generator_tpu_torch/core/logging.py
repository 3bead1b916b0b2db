"""The package logger ``mylog``, configured from the package config."""

from __future__ import annotations

import logging
import sys

from .config import cgparams

__all__ = ["mylog"]


def _build_main_logger() -> logging.Logger:
    cfg = cgparams["system"]["logging"]["main"]
    logger = logging.getLogger("cluster_generator_tpu_torch")
    if not logger.handlers:
        stream = sys.stdout if cfg["stream"].lower() == "stdout" else sys.stderr
        handler = logging.StreamHandler(stream=stream)
        handler.setFormatter(logging.Formatter(cfg["format"]))
        logger.addHandler(handler)
    logger.setLevel(cfg["level"])
    logger.propagate = False
    if not cfg.get("enabled", True):
        logger.disabled = True
    return logger


mylog = _build_main_logger()
