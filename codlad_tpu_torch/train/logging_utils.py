"""Training logs: a logger to stdout and `<exp>/log.txt`, and a JSONL sink.

Counterpart of `create_logger` and the JSONL part of `MetricsSink` in
codlad_tpu/train/logging_utils.py.
"""

from __future__ import annotations

import json
import logging
import os


def create_logger(logdir, name="codlad_torch"):
    os.makedirs(logdir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    for h in (logging.StreamHandler(), logging.FileHandler(os.path.join(logdir, "log.txt"))):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class MetricsSink:
    """Appends one JSON object {step, split, **metrics} a line to
    `<logdir>/metrics.jsonl`."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def log(self, metrics, step=None, split="train"):
        row = {"step": None if step is None else int(step), "split": split}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
