"""Synthetic all-atom proteins for tests, the smoke run and benchmarks.

A copy of codlad_tpu/data/synthetic.py: a self-avoiding C-alpha walk with
~3.8 Å virtual bonds and internal coordinates drawn from ideal values (or
the learnable rotamer-mode generator, `structured=True`), rebuilt with
NeRF and featurized. The same seed gives the same examples as the JAX
package.
"""

from __future__ import annotations

import numpy as np

from codlad_tpu_torch.data.featurize import FeaturizeConfig, featurize_frame
from codlad_tpu_torch.data.np_geometry import np_ic_to_xyz14
from codlad_tpu_torch.geometry import residues as R

# ideal heavy-atom bond lengths (Å) by element pair
_BOND_LEN = {
    frozenset(("C", "C")): 1.52,
    frozenset(("C", "N")): 1.47,
    frozenset(("C", "O")): 1.42,
    frozenset(("C", "S")): 1.81,
    frozenset(("O", "P")): 1.60,
    frozenset(("C", "P")): 1.80,
}
_Z_TO_E = {6: "C", 7: "N", 8: "O", 15: "P", 16: "S", 34: "SE"}


def _sc_bond_length(res_idx, k):
    z = R.ATOM14_ATOMIC_NUM[res_idx]
    child = _Z_TO_E.get(int(z[R.NUM_BB + k]), "C")
    parent_slot = int(R.SC_PARENTS[res_idx, k, 2])
    parent = _Z_TO_E.get(int(z[parent_slot]), "C")
    return _BOND_LEN.get(frozenset((child, parent)), 1.52)


def random_ca_trace(rng, n_res, step=3.8):
    xyz = [np.zeros(3), np.array([step, 0.0, 0.0])]
    direction = np.array([1.0, 0.0, 0.0])
    for _ in range(n_res - 2):
        for _ in range(64):
            new_dir = direction + rng.normal(size=3) * 0.7
            new_dir /= np.linalg.norm(new_dir)
            cos = float(np.dot(new_dir, direction))
            if -0.4 < cos < 0.9:
                cand = xyz[-1] + step * new_dir
                # weak self-avoidance against recent history
                recent = np.stack(xyz[-12:])
                if np.linalg.norm(recent - cand, axis=-1).min() > 3.4:
                    break
        direction = new_dir
        xyz.append(xyz[-1] + step * new_dir)
    return np.stack(xyz).astype(np.float64)


def random_ic(rng, res_type):
    """Plausible internal coordinates [L, 13, 3] for a residue-type vector."""
    L = len(res_type)
    ic = np.zeros((L, R.NUM_IC, 3), dtype=np.float64)
    # backbone rows: N (1.46 Å to CA), C (1.52 Å to CA), O (1.23 Å to C)
    ic[:, 0, 0] = 1.46 + rng.normal(0, 0.01, L)
    ic[:, 1, 0] = 1.52 + rng.normal(0, 0.01, L)
    ic[:, 2, 0] = 1.23 + rng.normal(0, 0.01, L)
    ic[:, :3, 1] = rng.uniform(1.2, 2.2, (L, 3))
    ic[:, :3, 2] = rng.uniform(-np.pi, np.pi, (L, 3))
    for i in range(L):
        for k in range(int(R.SC_COUNT[res_type[i]])):
            ic[i, 3 + k, 0] = _sc_bond_length(res_type[i], k) + rng.normal(0, 0.01)
            ic[i, 3 + k, 1] = rng.normal(1.94, 0.08)
            ic[i, 3 + k, 2] = rng.uniform(-np.pi, np.pi)
    return ic


# ---------------------------------------------------------------------------
# structured (learnable) generator — for convergence studies.
#
# The plain `random_ic` draws i.i.d. torsions per frame: that signal is
# incompressible through a 3-dim/residue latent, so Stage-1 recon has no
# floor to approach and Stage-2 has nothing to learn.  The structured mode
# instead gives every residue a discrete ROTAMER STATE (3 modes per residue
# type, fixed global tables) whose probability depends on the local CA-trace
# dihedral, plus small gaussian jitter:
#
#   * Stage 1 can encode (residue type x mode + jitter) in its latent and
#     reconstruct torsions to the jitter floor;
#   * Stage 2 must model p(mode | trace geometry) — a genuine conditional
#     distribution with entropy, like side-chain rotamers in real proteins.

_N_MODES = 3
_TABLE_SEED = 20260819


def _structured_tables():
    """Fixed global tables (independent of the per-frame rng)."""
    trng = np.random.default_rng(_TABLE_SEED)
    n_types = R.NUM_RESTYPES
    centers = trng.uniform(-np.pi, np.pi, size=(n_types, 10, _N_MODES))
    # keep modes well separated per (type, slot): spread them a third of a
    # turn apart around a random phase
    base = trng.uniform(-np.pi, np.pi, size=(n_types, 10, 1))
    centers = base + np.arange(_N_MODES)[None, None, :] * (2 * np.pi / _N_MODES)
    centers = (centers + np.pi) % (2 * np.pi) - np.pi
    angles = trng.normal(1.94, 0.12, size=(n_types, 10))
    phases = trng.uniform(-np.pi, np.pi, size=_N_MODES)
    return centers, angles, phases


_ROT_CENTERS, _ANGLE_CENTERS, _MODE_PHASES = _structured_tables()


def _trace_dihedrals(cg):
    """Praxeolitic dihedral over CA quadruples, one per TRIMMED residue
    (residue i of the trimmed chain uses CA[i-1..i+2] of the full trace);
    ends fall back to 0."""
    n = cg.shape[0]
    th = np.zeros(n - 2)
    for i in range(n - 3):
        p0, p1, p2, p3 = cg[i], cg[i + 1], cg[i + 2], cg[i + 3]
        b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
        b1n = b1 / max(np.linalg.norm(b1), 1e-8)
        v = b0 - np.dot(b0, b1n) * b1n
        w = b2 - np.dot(b2, b1n) * b1n
        x = np.dot(v, w)
        y = np.dot(np.cross(b1n, v), w)
        th[i] = np.arctan2(y, x)
    return th


def structured_ic(rng, res_type, cg, noise=0.05):
    """Internal coordinates with learnable structure (see module note).

    cg: the FULL (untrimmed) CA trace [L+2, 3]; res_type: trimmed [L]."""
    L = len(res_type)
    theta = _trace_dihedrals(cg)  # [L]
    ic = np.zeros((L, R.NUM_IC, 3), dtype=np.float64)
    # backbone: near-rigid bonds; angles/torsions smooth functions of the
    # local trace dihedral (deterministic given the CG input, + jitter)
    ic[:, 0, 0] = 1.46 + rng.normal(0, 0.004, L)
    ic[:, 1, 0] = 1.52 + rng.normal(0, 0.004, L)
    ic[:, 2, 0] = 1.23 + rng.normal(0, 0.004, L)
    for r in range(3):
        ic[:, r, 1] = 1.7 + 0.25 * np.sin(theta + r) + rng.normal(0, 0.01, L)
        ic[:, r, 2] = (0.4 * r - 1.0 + 0.8 * np.cos(theta + 0.5 * r)
                       + rng.normal(0, 0.01, L))
    # side chains: one rotamer mode per residue, trace-conditioned weights
    logits = 2.0 * np.cos(theta[:, None] + _MODE_PHASES[None, :])  # [L, M]
    gumbel = rng.gumbel(size=(L, _N_MODES))
    modes = np.argmax(logits + gumbel, axis=-1)
    for i in range(L):
        t = res_type[i]
        for k in range(int(R.SC_COUNT[t])):
            ic[i, 3 + k, 0] = _sc_bond_length(t, k) + rng.normal(0, 0.004)
            ic[i, 3 + k, 1] = _ANGLE_CENTERS[t, k] + rng.normal(0, 0.02)
            tor = _ROT_CENTERS[t, k, modes[i]] + rng.normal(0, noise)
            ic[i, 3 + k, 2] = (tor + np.pi) % (2 * np.pi) - np.pi
    return ic


def random_protein(rng, n_res_og, exclude_phospho=True, structured=False):
    """Sample (res_type_og, chain_id_og, cg_xyz_og, xyz14) for one frame."""
    hi = 20 if exclude_phospho else 22
    res_type_og = rng.integers(0, hi, size=n_res_og).astype(np.int32)
    chain_id_og = np.zeros(n_res_og, dtype=np.int32)
    cg = random_ca_trace(rng, n_res_og)
    res_type = res_type_og[1:-1]
    ic = (structured_ic(rng, res_type, cg) if structured
          else random_ic(rng, res_type))
    xyz14 = np_ic_to_xyz14(cg, ic, res_type)
    return res_type_og, chain_id_og, cg.astype(np.float32), xyz14.astype(np.float32)


def synthetic_examples(n_frames, n_res_og, seed=0, cfg: FeaturizeConfig | None = None,
                       prot_idx=0, same_protein=True, structured=False):
    """Generate featurized examples; `same_protein` reuses one sequence and
    jitters the trace/side chains per frame (like frames of one protein).
    `structured` switches to the learnable rotamer-mode generator."""
    rng = np.random.default_rng(seed)
    examples = []
    res_type_og, chain_id_og, base_cg, base_xyz14 = random_protein(
        rng, n_res_og, structured=structured)
    for f in range(n_frames):
        if not same_protein:
            inputs = random_protein(rng, n_res_og, structured=structured)
        elif f == 0:
            inputs = (res_type_og, chain_id_og, base_cg, base_xyz14)
        else:
            cg = (base_cg + rng.normal(0, 0.3, base_cg.shape)).astype(np.float32)
            ic = (structured_ic(rng, res_type_og[1:-1], cg.astype(np.float64))
                  if structured else random_ic(rng, res_type_og[1:-1]))
            xyz14 = np_ic_to_xyz14(cg.astype(np.float64), ic, res_type_og[1:-1]).astype(np.float32)
            inputs = (res_type_og, chain_id_og, cg, xyz14)
        examples.append(featurize_frame(*inputs, cfg=cfg, prot_idx=prot_idx))
    return examples


def corpus_protein(index, n_frames, seed=0, res_range=(48, 128), structured=True):
    """The first n_frames of protein `index` of a synthetic corpus as
    codlad_tpu/cli/preprocess.py `--synthetic N_PROT N_RES N_FRAMES
    --structured --res_range LO HI --seed S` draws it: its length is the
    (index+1)-th draw of default_rng(S + 991), its frames those of
    synthetic_examples(seed=S + index). The convergence study's val
    proteins are index 30 and 31 at the defaults."""
    lens_rng = np.random.default_rng(seed + 991)
    for _ in range(index + 1):
        n_res = int(lens_rng.integers(res_range[0], res_range[1] + 1))
    return synthetic_examples(n_frames, n_res, seed=seed + index, prot_idx=index,
                              structured=structured)


def write_structure_files(out_dir, name, n_res, n_frames, seed=0, pdb_dir=None, xtc_dir=None):
    """A synthetic protein of n_res residues as files a user would bring:
    its first frame as `{name}.pdb` (the topology) and all n_frames as
    `{name}.xtc` (nm), written by data/pdb.py `write_pdb` and data/xtc.py
    `write_xtc`; the frames are random_protein's with the trace jittered by
    N(0, 0.3^2) Å and fresh side chains. Returns the frames' xyz14 [F,
    n_res, 14, 3] (Å) and res_type [n_res]."""
    import os

    from codlad_tpu_torch.data.pdb import write_pdb
    from codlad_tpu_torch.data.xtc import write_xtc

    rng = np.random.default_rng(seed)
    # two more residues around the ones written: write_pdb writes the modeled
    # residues [1:-1] of its res_type_og
    res_type_og, chain_id_og, cg, xyz14 = random_protein(rng, n_res + 2)
    frames = [xyz14]
    for _ in range(n_frames - 1):
        jit = (cg + rng.normal(0, 0.3, cg.shape)).astype(np.float64)
        frames.append(np_ic_to_xyz14(jit, random_ic(rng, res_type_og[1:-1]),
                                     res_type_og[1:-1]).astype(np.float32))
    frames = np.stack(frames)
    pdb_dir, xtc_dir = pdb_dir or out_dir, xtc_dir or out_dir
    os.makedirs(pdb_dir, exist_ok=True)
    os.makedirs(xtc_dir, exist_ok=True)
    write_pdb(os.path.join(pdb_dir, f"{name}.pdb"), res_type_og, chain_id_og, frames[:1])
    res_type = res_type_og[1:-1]
    write_xtc(os.path.join(xtc_dir, f"{name}.xtc"), frames[:, R.ATOM14_EXISTS[res_type]] / 10.0)
    return frames, res_type
