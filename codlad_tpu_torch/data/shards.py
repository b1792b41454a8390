"""Per-protein `.npz` shards and constant-size batches over them.

Copies of `save_protein_shard`, `load_protein_shard`, `iter_padded_batches`
and `ShardDataset` from codlad_tpu/data/shards.py: one shard holds every
featurized frame of one protein, padded to a PadSpec snapped onto the
global bucket lattice, so shards written by the JAX `cli.preprocess` and by
the port read the same.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile

import numpy as np

from codlad_tpu_torch.data import batch as B


def _savez_fast(path, **arrays):
    """np.savez_compressed at deflate level 1 (padded shards are mostly
    zeros; level 1 compresses nearly as well and much faster)."""
    tmp = os.fspath(path) + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        for k, v in arrays.items():
            with zf.open(f"{k}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(v), allow_pickle=False)
    os.replace(tmp, path)


def save_protein_shard(path, examples, spec: B.PadSpec | None = None):
    """Featurized frames of ONE protein -> a padded .npz shard; returns the
    (lattice-snapped) PadSpec."""
    spec = spec or B.quantize_spec(B.spec_for(examples))
    _savez_fast(path, __spec__=np.array(json.dumps(dataclasses.asdict(spec))),
                **B.collate(examples, spec))
    return spec


def load_protein_shard(path):
    """-> (PadSpec, {key: [n_frames, ...] array})."""
    with np.load(path, allow_pickle=False) as z:
        spec = B.PadSpec(**json.loads(str(z["__spec__"])))
        return spec, {k: z[k] for k in z.files if k != "__spec__"}


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


class ShardDataset:
    """Frame batches from a directory of per-protein shards. Batches never
    mix shards; shard order and frame order shuffle per epoch when
    `shuffle`; the tail batch of a shard is padded with mask-zeroed
    duplicates."""

    def __init__(self, directory, batch_size, seed=0, shuffle=True):
        self.directory = directory
        self.files = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"no .npz shards in {directory}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        files = list(self.files)
        if self.shuffle:
            self._rng.shuffle(files)
        for fname in files:
            _, data = load_protein_shard(os.path.join(self.directory, fname))
            idx = np.arange(data["res_type"].shape[0])
            if self.shuffle:
                self._rng.shuffle(idx)
            yield from iter_padded_batches(data, self.batch_size, idx)
