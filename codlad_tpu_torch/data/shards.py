"""Per-protein `.npz` shards and constant-size batches over them.

Copies of `save_protein_shard`, `load_protein_shard`, `iter_padded_batches`,
`ShardDataset` and `MixedShardDataset` from codlad_tpu/data/shards.py: one shard holds every
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


class MixedShardDataset:
    """Frame batches that mix proteins within a padding bucket (the Stage-1
    trainer's default, -mix_batches). Shards are grouped by their PadSpec,
    so their padded arrays concatenate; within a group a bounded pool of
    frames is filled from shuffled shards, shuffled and drained as full
    batches. Every frame appears once an epoch; each group's tail batch is
    mask-padded. The numpy generator is called as the JAX package calls it,
    so a seed gives its batches in its order."""

    def __init__(self, directory, batch_size, seed=0, shuffle=True, pool_frames=4096):
        self.directory = directory
        self.files = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"no .npz shards in {directory}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pool_frames = max(pool_frames, batch_size)
        self._rng = np.random.default_rng(seed)
        self._groups = {}
        for f in self.files:
            spec, _ = load_protein_shard(os.path.join(directory, f))
            key = json.dumps(dataclasses.asdict(spec), sort_keys=True)
            self._groups.setdefault(key, []).append(f)

    def _drain(self, chunks, count, final):
        """Emit batches from the pooled chunks; return the remainder."""
        if count == 0:
            return [], 0
        data = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        idx = np.arange(count)
        if self.shuffle:
            self._rng.shuffle(idx)
        n_emit = count if final else (count // self.batch_size) * self.batch_size
        if n_emit:
            yield from iter_padded_batches(data, self.batch_size, idx[:n_emit])
        rest = idx[n_emit:]
        if rest.size:
            return [{k: v[rest] for k, v in data.items()}], rest.size
        return [], 0

    def __iter__(self):
        group_keys = list(self._groups)
        if self.shuffle:
            self._rng.shuffle(group_keys)
        for key in group_keys:
            files = list(self._groups[key])
            if self.shuffle:
                self._rng.shuffle(files)
            chunks, count = [], 0
            for fname in files:
                _, data = load_protein_shard(os.path.join(self.directory, fname))
                chunks.append(data)
                count += data["res_type"].shape[0]
                if count >= self.pool_frames:
                    chunks, count = yield from self._drain(chunks, count, final=False)
            yield from self._drain(chunks, count, final=True)
