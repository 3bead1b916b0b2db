"""The package loggers ``mylog`` and ``devLogger`` (a file log, off unless
the config names a directory), configured from the package config."""

from __future__ import annotations

import logging
import sys

from .config import cgparams

__all__ = ["mylog", "devLogger"]


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


def _build_dev_logger() -> logging.Logger:
    cfg = cgparams["system"]["logging"]["developer"]
    logger = logging.getLogger("cluster_generator_tpu_torch.dev")
    logger.propagate = False
    if cfg.get("enabled") and cfg.get("output_directory"):
        import os
        from datetime import datetime

        path = os.path.join(cfg["output_directory"],
                            f"{datetime.now().strftime('%m-%d-%y_%H-%M-%S')}.log")
        handler = logging.FileHandler(path)
        handler.setFormatter(
            logging.Formatter(cgparams["system"]["logging"]["main"]["format"]))
        logger.addHandler(handler)
        logger.setLevel("DEBUG")
    else:
        logger.disabled = True
    return logger


mylog = _build_main_logger()
devLogger = _build_dev_logger()
