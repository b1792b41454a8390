"""Constant-size batches over an index list.

Copy of `iter_padded_batches` from codlad_tpu/data/shards.py.
"""

from __future__ import annotations

import numpy as np


def iter_padded_batches(data, batch_size, idx, n_valid=None):
    """Yield batches of `batch_size` rows covering every index in
    `idx[:n_valid]` exactly once. A partial batch is padded by repeating its
    first frame with every `*mask` key zeroed, so masked losses ignore the
    padding and the batch shape stays the same; rows of `idx` at positions
    >= n_valid are padding too."""
    if n_valid is None:
        n_valid = idx.size
    for s in range(0, idx.size, batch_size):
        sel = idx[s:s + batch_size]
        valid = min(max(n_valid - s, 0), sel.size)
        if sel.size < batch_size:
            fill = sel[0] if sel.size else idx[0]
            sel = np.concatenate(
                [sel, np.full(batch_size - sel.size, fill, dtype=idx.dtype)])
        out = {k: v[sel] for k, v in data.items()}
        if valid < batch_size:
            for k, v in out.items():
                if k.endswith("mask"):
                    v = v.copy()
                    v[valid:] = False if v.dtype == bool else 0
                    out[k] = v
        yield out
