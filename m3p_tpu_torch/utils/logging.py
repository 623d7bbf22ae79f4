"""Experiment logging (counterpart of `m3p_tpu/utils/logging.py`): one
logger with elapsed-time prefixes writing to ``train.log`` in the dump
directory and to stdout, and the dump directory with the config as
``params.json``.  The logger is the port's package logger,
``m3p_tpu_torch``, which every module of the port logs to."""

from __future__ import annotations

import logging
import os
import random
import string
import sys
import time
from datetime import timedelta
from typing import Optional

LOGGER_NAME = "m3p_tpu_torch"


class ElapsedFormatter(logging.Formatter):
    """``INFO - 00:01:23 - <date> - message`` (reference `logger.py:13-28`)."""

    def __init__(self) -> None:
        super().__init__()
        self.start_time = time.time()

    def format(self, record: logging.LogRecord) -> str:
        elapsed = timedelta(seconds=round(record.created - self.start_time))
        prefix = f"{record.levelname} - {elapsed} - {time.strftime('%x %X')}"
        return f"{prefix} - {record.getMessage()}"


def create_logger(filepath: Optional[str] = None,
                  process_index: int = 0) -> logging.Logger:
    """The package logger, its handlers replaced by a file handler on
    ``filepath`` (``<filepath>-<rank>`` above rank 0) and a stdout one."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    formatter = ElapsedFormatter()
    if filepath is not None:
        if process_index > 0:
            filepath = f"{filepath}-{process_index}"
        fh = logging.FileHandler(filepath, "a")
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    return logger


def get_dump_path(dump_path: str, exp_name: str, exp_id: str = "") -> str:
    """``dump_path/exp_name/exp_id``, created, with a random id when none
    is given."""
    if not exp_name:
        raise ValueError("exp_name must not be empty")
    if not exp_id:
        chars = string.ascii_lowercase + string.digits
        exp_id = "".join(random.choice(chars) for _ in range(10))
    path = os.path.join(dump_path, exp_name, exp_id)
    os.makedirs(path, exist_ok=True)
    return path


def initialize_exp(cfg, process_index: int = 0) -> logging.Logger:
    """Create the dump directory, point ``cfg.dump_path`` at it, write the
    config there as ``params.json`` (`TrainConfig.to_json`) and return the
    logger writing ``train.log`` beside it."""
    dump = get_dump_path(cfg.dump_path, cfg.exp_name, cfg.exp_id)
    cfg.dump_path = dump
    with open(os.path.join(dump, "params.json"), "w") as f:
        f.write(cfg.to_json())
    logger = create_logger(os.path.join(dump, "train.log"), process_index)
    logger.info("============ Initialized experiment ============")
    logger.info("The experiment will be stored in %s", dump)
    logger.info("Running command: %s", " ".join(sys.argv))
    return logger
