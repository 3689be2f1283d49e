"""Logger setup (port of ``utils/logger.py``: detectron2's ``utils/logger.py`` and HRNet's ``create_logger``).

`setup_logger` configures colored console + optional file logging;
`create_output_tree` reproduces the HRNet output-directory convention
``OUTPUT_DIR/<dataset>/<model>/<cfg_name>`` (lib/utils/utils.py:22-57).
"""

from __future__ import annotations

import logging
import os
import sys
import time


class _ColorFormatter(logging.Formatter):
    COLORS = {"WARNING": "\x1b[33m", "ERROR": "\x1b[31m", "CRITICAL": "\x1b[31m"}

    def format(self, record):
        msg = super().format(record)
        color = self.COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"{color}{msg}\x1b[0m"
        return msg


def setup_logger(output: str | None = None, name: str = "spe", level=logging.INFO):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = _ColorFormatter("[%(asctime)s %(name)s %(levelname)s] %(message)s",
                          datefmt="%m/%d %H:%M:%S")
    ch = logging.StreamHandler(sys.stderr)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if output:
        os.makedirs(output, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output, "log.txt"))
        fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
        logger.addHandler(fh)
    return logger


def create_output_tree(root: str, dataset: str, model: str, cfg_name: str) -> tuple[str, str]:
    """(final_output_dir, tb_log_dir) in the HRNet layout."""
    final = os.path.join(root, dataset, model, cfg_name)
    tb = os.path.join(root, "log", dataset, model,
                      f"{cfg_name}_{time.strftime('%Y-%m-%d-%H-%M')}")
    os.makedirs(final, exist_ok=True)
    os.makedirs(tb, exist_ok=True)
    return final, tb
