"""Training logs and run control: a logger to stdout and `<exp>/log.txt`, a
JSONL sink, the CSV epoch log, LOWESS smoothing, early stopping, the
plateau learning rate, selection replay and a timer.

Counterpart of codlad_tpu/train/logging_utils.py (copies; the JSONL part
of `MetricsSink`, without its wandb mirror).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time

import numpy as np


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
    `<logdir>/metrics.jsonl` (split "train", or "val" for validation rows)."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def log(self, metrics, step=None, split="train"):
        row = {"step": None if step is None else int(step), "split": split}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


def best_val_from_metrics(logdir):
    """The lowest finite validation loss among the `split: val` rows of
    `<logdir>/metrics.jsonl` (inf when there is none): a resumed run's
    best-checkpoint selection starts from it."""
    best = np.inf
    path = os.path.join(logdir, "metrics.jsonl")
    if not os.path.exists(path):
        return best
    with open(path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except ValueError:
                continue
            v = row.get("loss")
            if row.get("split") == "val" and isinstance(v, (int, float)) and np.isfinite(v):
                best = min(best, float(v))
    return best


class CSVLogger:
    def __init__(self, path, fieldnames):
        self.path = path
        self.fieldnames = list(fieldnames)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, self.fieldnames).writeheader()

    def append(self, row):
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, self.fieldnames).writerow(
                {k: row.get(k, "") for k in self.fieldnames})


def lowess_smooth(y, frac=0.3):
    """Tricube-weighted local linear regression (statsmodels-free LOWESS)."""
    y = np.asarray(y, np.float64)
    n = len(y)
    if n < 3:
        return y.copy()
    x = np.arange(n, dtype=np.float64)
    k = max(int(np.ceil(frac * n)), 2)
    out = np.empty(n)
    for i in range(n):
        d = np.abs(x - x[i])
        cut = np.sort(d)[k - 1]
        w = np.clip(1 - (d / max(cut, 1e-12)) ** 3, 0, 1) ** 3
        sw = w.sum()
        xm = (w * x).sum() / sw
        ym = (w * y).sum() / sw
        cov = (w * (x - xm) * (y - ym)).sum()
        var = (w * (x - xm) ** 2).sum()
        b = cov / var if var > 1e-12 else 0.0
        out[i] = ym + b * (x[i] - xm)
    return out


class EarlyStopping:
    """Stop after `patience` epochs without an improvement > min_delta."""

    def __init__(self, patience=20, min_delta=0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = None
        self.early_stop = False

    def __call__(self, val_loss):
        if self.best_loss is None or self.best_loss - val_loss > self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


class PlateauLR:
    """ReduceLROnPlateau: lr * factor after `patience` epochs without an
    improvement > threshold, then `cooldown` epochs of grace."""

    def __init__(self, lr, factor=0.3, patience=5, threshold=1e-3,
                 min_lr=1e-8, cooldown=1):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.best = None
        self.bad = 0
        self.cool = 0

    def step(self, val_loss):
        """Returns the (possibly reduced) lr."""
        if self.best is None or val_loss < self.best - self.threshold:
            self.best = val_loss
            self.bad = 0
        elif self.cool > 0:
            self.cool -= 1
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
                self.cool = self.cooldown
        return self.lr


def read_epoch_rows(csv_path):
    """Rows of a train_log.csv deduped by epoch (the last occurrence wins)
    and sorted: a resumed run may have re-appended epochs it re-ran."""
    if not os.path.exists(csv_path):
        return []
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    by_epoch = {}
    for r in rows:
        try:
            by_epoch[int(float(r["epoch"]))] = r
        except (KeyError, TypeError, ValueError):
            continue
    return [by_epoch[e] for e in sorted(by_epoch)]


def rewrite_epoch_rows(csv_path, rows, fieldnames):
    """Atomically rewrite train_log.csv with deduped rows."""
    tmp = csv_path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in fieldnames})
    os.replace(tmp, csv_path)


def replay_selection(val_losses, plateau=None, stopper=None):
    """Re-derive the best-model / plateau-LR / early-stop state from the
    validation-loss history a resumed run left on disk, through the same
    selection logic the live loop runs, so a resume is state-equivalent to
    never having stopped. Mutates `plateau` and `stopper` in place. Returns
    (val_history, best_val, best_epoch), best_epoch indexing val_losses (-1
    if empty)."""
    val_history, best_val, best_epoch = [], np.inf, -1
    for i, v in enumerate(val_losses):
        v = float(v)
        if not np.isfinite(v):
            continue  # the live loop aborts on NaN before selection
        val_history.append(v)
        smoothed = lowess_smooth(val_history)[-1]
        if plateau is not None:
            plateau.step(smoothed)
        if smoothed < best_val:
            best_val, best_epoch = smoothed, i
        if stopper is not None:
            stopper(smoothed)
    return val_history, best_val, best_epoch


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self):
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
