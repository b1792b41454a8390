"""CG inference batches: synthetic C-alpha traces, the CG radius graph and
the padding of the keys the sampling path reads.

Copies of the CG edge list of `featurize_frame`
(codlad_tpu/data/featurize.py) and the padding of `pad_example`
(codlad_tpu/data/batch.py) for res_type, res_mask, cg_xyz_og [B, L+2, 3],
cg_edges and cg_edges_mask; the traces are `data.synthetic.random_ca_trace`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from codlad_tpu_torch.data.synthetic import random_ca_trace


def cg_radius_edges(cg_xyz_og, cutoff=21.0):
    """One-way (i < j) pairs of modeled residues within `cutoff` Å -> [E, 2]."""
    cg_here = np.asarray(cg_xyz_og, dtype=np.float64)[1:-1]
    L = len(cg_here)
    dcg = np.linalg.norm(cg_here[:, None] - cg_here[None, :], axis=-1)
    ci, cj = np.where((dcg <= cutoff) & np.triu(np.ones((L, L), dtype=bool), k=1))
    return np.stack([ci, cj], axis=-1).astype(np.int32)


def featurize_cg(res_type_og, cg_xyz_og, cutoff=21.0):
    """One frame: res_type_og [L+2] and cg_xyz_og [L+2, 3] include the two
    terminal residues, which serve only as reference frames."""
    return {"res_type": np.asarray(res_type_og[1:-1], dtype=np.int32),
            "cg_xyz_og": np.asarray(cg_xyz_og, dtype=np.float32),
            "cg_edges": cg_radius_edges(cg_xyz_og, cutoff)}


def _round_up(n, multiple):
    return int(math.ceil(max(n, 1) / multiple) * multiple)


def collate_cg(examples, L=None, edge_multiple=512):
    """Pad frames to L residues (default: the longest, rounded up to 16)
    and the edge lists to a multiple of `edge_multiple`; stack to [B, ...]."""
    L = L or _round_up(max(len(e["res_type"]) for e in examples), 16)
    cap = _round_up(max(len(e["cg_edges"]) for e in examples), edge_multiple)

    def pad_to(a, length):
        return np.pad(a, [(0, length - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    rows = []
    for e in examples:
        n, ne = len(e["res_type"]), len(e["cg_edges"])
        if n > L:
            raise ValueError(f"frame of {n} residues does not fit L={L}")
        rows.append({"res_type": pad_to(e["res_type"], L),
                     "res_mask": pad_to(np.ones(n, dtype=bool), L),
                     "cg_xyz_og": pad_to(e["cg_xyz_og"], L + 2),
                     "cg_edges": pad_to(e["cg_edges"], cap),
                     "cg_edges_mask": pad_to(np.ones(ne, dtype=bool), cap)})
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def synthetic_cg_batch(n_frames, n_res, seed=0, L=None):
    """n_frames independent random proteins of n_res modeled residues
    (residue types 0..19, as the synthetic corpus draws them)."""
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n_frames):
        res_type_og = rng.integers(0, 20, size=n_res + 2).astype(np.int32)
        cg = random_ca_trace(rng, n_res + 2).astype(np.float32)
        examples.append(featurize_cg(res_type_og, cg))
    return collate_cg(examples, L=L)


def to_device(batch, device="cuda"):
    """numpy batch -> dict of tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def write_synthetic_features(out_dir, n_frames, n_res, seed=0, latent_size=3,
                             files=1):
    """Feature files in the extractor's layout (`latents`, `res_type`,
    `cg_xyz_og`, `res_mask`) for n_frames synthetic proteins of n_res
    residues, with N(0, 1) latents; split over `files` npz files."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    batch = synthetic_cg_batch(n_frames, n_res, seed=seed)
    rng = np.random.default_rng(seed + 1)
    latents = rng.standard_normal((n_frames, batch["res_type"].shape[1], latent_size))
    parts = np.array_split(np.arange(n_frames), files)
    for i, rows in enumerate(parts):
        np.savez(os.path.join(out_dir, f"features_{i:03d}.npz"),
                 latents=latents[rows].astype(np.float32), res_type=batch["res_type"][rows],
                 cg_xyz_og=batch["cg_xyz_og"][rows], res_mask=batch["res_mask"][rows])
