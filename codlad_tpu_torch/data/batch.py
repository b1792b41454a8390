"""Static padded batching for variable-length proteins.

A copy of `PadSpec`, `spec_for`, `LENGTH_LATTICE`, `quantize_spec`,
`merge_specs`, `pad_example`, `collate` and `compress_indices` from
codlad_tpu/data/batch.py: every extent padded to a length bucket and an edge
capacity, with boolean masks for validity. `to_device` and
`decompress_indices` carry the compressed edge lists to the card and back to
int32 there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EDGE_KEYS = {
    "atom_edges": 2,
    "cg_edges": 2,
    "bond_edges": 2,
    "clash_edges": 2,
    "inter_edges": 2,
    "pipi_pairs": 4,
    "bb_no_edges": 2,
}


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static extents of one compilation bucket."""

    L: int  # modeled residues
    atom_edges: int
    cg_edges: int
    bond_edges: int
    clash_edges: int
    inter_edges: int
    pipi_pairs: int
    bb_no_edges: int

    def edge_capacity(self, key):
        return getattr(self, key)


def _round_up(n, multiple):
    return int(math.ceil(max(n, 1) / multiple) * multiple)


def spec_for(examples, length_multiple=16, edge_multiple=512) -> PadSpec:
    """Smallest PadSpec covering a set of featurized examples."""
    L = _round_up(max(len(e["res_type"]) for e in examples), length_multiple)
    caps = {}
    for key in EDGE_KEYS:
        caps[key] = _round_up(max(len(e[key]) for e in examples), edge_multiple)
    return PadSpec(L=L, **caps)


# Global length lattice: ~1.33x geometric steps so any dataset lands on a
# handful of shared compilation buckets (<= 33% padding waste) instead of
# one XLA program per protein length.
LENGTH_LATTICE = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
                  1536, 2048)


def _lattice_up(n, lattice=LENGTH_LATTICE):
    for v in lattice:
        if n <= v:
            return v
    return _round_up(n, lattice[-1])


def _pow2_up(n, minimum=512):
    v = minimum
    while v < n:
        v *= 2
    return v


def quantize_spec(spec: PadSpec) -> PadSpec:
    """Snap a PadSpec onto the global bucket lattice (length lattice +
    power-of-two edge caps).  Full cross-protein bucket sharing
    additionally unifies edge caps per L-bucket at dataset level —
    see shards.align_shard_buckets (edge densities vary ~10x between
    extended and globular chains, so fixed L->edges ratios would waste
    compute in the per-edge tensor products)."""
    caps = {k: _pow2_up(spec.edge_capacity(k)) for k in EDGE_KEYS}
    return PadSpec(L=_lattice_up(spec.L), **caps)


def merge_specs(specs) -> PadSpec:
    """Upper envelope of PadSpecs (same or mixed L)."""
    specs = list(specs)
    return PadSpec(
        L=max(s.L for s in specs),
        **{k: max(s.edge_capacity(k) for s in specs) for k in EDGE_KEYS})


def pad_example(ex, spec: PadSpec):
    """Pad one example to a PadSpec; returns dict of fixed-shape arrays."""
    L = spec.L
    n = len(ex["res_type"])
    assert n <= L, (n, L)
    out = {}

    def pad_to(a, length, axis=0):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, length - a.shape[axis])
        return np.pad(a, pad)

    out["res_type"] = pad_to(ex["res_type"], L)
    out["res_mask"] = pad_to(np.ones(n, dtype=bool), L)
    out["chain_id"] = pad_to(ex["chain_id"], L)
    out["cg_xyz_og"] = pad_to(ex["cg_xyz_og"], L + 2)
    out["xyz14"] = pad_to(ex["xyz14"], L)
    out["ic"] = pad_to(ex["ic"], L)
    out["ic_mask"] = pad_to(ex["ic_mask"], L)
    out["atom_mask"] = pad_to(ex["atom_mask"] & np.ones(n, dtype=bool)[:, None], L)
    out["endpoint_mask"] = pad_to(ex["endpoint_mask"], L)
    out["prot_idx"] = np.asarray(ex["prot_idx"], dtype=np.int32)

    for key in EDGE_KEYS:
        cap = spec.edge_capacity(key)
        e = ex[key]
        assert len(e) <= cap, (key, len(e), cap)
        out[key] = pad_to(e.astype(np.int32), cap)
        out[key + "_mask"] = pad_to(np.ones(len(e), dtype=bool), cap)
    return out


def collate(examples, spec: PadSpec | None = None):
    """Stack featurized examples into one fixed-shape batch dict [B, ...]."""
    spec = spec or spec_for(examples)
    padded = [pad_example(e, spec) for e in examples]
    return {k: np.stack([p[k] for p in padded]) for k in padded[0]}


def compress_indices(batch):
    """Edge-index arrays downcast to uint16 for the host -> device copy
    (flat atom14 indices < 14 L, so uint16 is exact for L <= 4681; the edge
    lists are the bulk of a Stage-1 batch's bytes). Pair with
    `decompress_indices` on the device."""
    L = batch["res_type"].shape[-1] if "res_type" in batch else None
    if L is None or L * 14 > np.iinfo(np.uint16).max:
        return batch
    return {k: (v.astype(np.uint16) if k in EDGE_KEYS and v.dtype == np.int32 else v)
            for k, v in batch.items()}


def to_device(batch, device):
    """numpy batch -> tensors on `device`; uint16 arrays travel as their
    int16 bit pattern (torch's uint16 has few operations on every build)."""
    import torch

    return {k: torch.as_tensor(v.view(np.int16) if v.dtype == np.uint16 else v,
                               device=device) for k, v in batch.items()}


def decompress_indices(batch):
    """Compressed edge lists (the int16 bit pattern `to_device` carries, or
    uint16) back to int32 indices; every other entry as it is."""
    import torch

    small = {torch.int16, getattr(torch, "uint16", torch.int16)}
    return {k: ((v.to(torch.int32) & 0xFFFF) if k in EDGE_KEYS and v.dtype in small else v)
            for k, v in batch.items()}
