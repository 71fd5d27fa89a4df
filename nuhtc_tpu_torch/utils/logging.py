"""Root logger and metric sinks (port of nuhtc_tpu/utils/logging.py).

``MetricLogger`` writes scalars and images to tensorboardX and, when asked,
to wandb; each is imported where it is used and raises ImportError by name
where it is missing.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_loggers = {}


def get_root_logger(log_file: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """The package's logger: to stderr and, from the first call that names
    one, to ``log_file`` too."""
    name = "nuhtc_tpu_torch"
    logger = _loggers.get(name)
    if logger is None:
        logger = logging.getLogger(name)
        logger.setLevel(level)
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - "
                                               "%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        _loggers[name] = logger
    if log_file:
        path = os.path.abspath(log_file)
        if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logger.handlers[0].formatter)
            logger.addHandler(fh)
    return logger


class MetricLogger:
    """Scalar and image sink: tensorboardX, and wandb with ``use_wandb``."""

    def __init__(self, log_dir: str, use_wandb: bool = False, wandb_kwargs=None):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise ImportError("MetricLogger needs tensorboardX, which is not installed") from e
        self.tb = SummaryWriter(log_dir)
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise ImportError("MetricLogger(use_wandb=True) needs wandb, which is not "
                                  "installed") from e
            self.wandb = wandb
            self.wandb_run = wandb.init(**(wandb_kwargs or {}))

    def log_scalars(self, scalars: dict, step: int):
        for k, v in scalars.items():
            self.tb.add_scalar(k, v, step)
        if self.wandb:
            self.wandb.log(scalars, step=step)

    def log_image(self, tag: str, img, step: int):
        self.tb.add_image(tag, img, step, dataformats="HWC")
        if self.wandb:
            self.wandb.log({tag: self.wandb.Image(img)}, step=step)

    def close(self):
        self.tb.close()
        if self.wandb:
            self.wandb_run.finish()
