"""Minimal PDB reader/writer for heavy-atom protein structures.

A copy of codlad_tpu/data/pdb.py for the port (`parse_pdb`, `PDBParseError`,
`load_xtc_ensemble`, `write_pdb`), on the port's residue tables
(geometry/residues.py) and XTC reader (data/xtc.py).

The reference delegates IO/topology to mdtraj (reference:
utils/protein_module.py:878-918); this environment has no mdtraj, so a
small self-contained parser covers the framework's needs: ATOM records of
the 22 supported residue types, multi-MODEL ensembles, multiple chains,
hydrogens dropped.  Output into the canonical atom14 layout used everywhere
else, plus a writer for exporting generated ensembles as multi-MODEL PDB.
Atlas-style xtc trajectories load through `load_xtc_ensemble` (topology
PDB + xtc replicas, self-contained codec in data/xtc.py).
"""

from __future__ import annotations

import gzip

import numpy as np

from codlad_tpu_torch.geometry import residues as R


class PDBParseError(ValueError):
    pass


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def parse_pdb(path, model_index=None, return_topology=False):
    """Parse a PDB file into frames of the atom14 layout.

    Returns dict with:
      res_type_og [R] int32, chain_id_og [R] int32,
      cg_xyz_og [F, R, 3] f32, xyz14 [F, R-2, 14, 3] f32,
      atom14_mask [R-2, 14] bool (atoms actually present in the file).

    With return_topology=True, returns the raw parse instead:
    (models, order, res_names, file_atoms) where file_atoms lists EVERY
    first-model atom line in file order as (res_key, atom_name, kept) —
    the mapping needed to scatter xtc coordinate streams (which follow
    the topology's atom order) onto residues.
    """
    models = []   # list of dict (chain, resseq) -> {atom_name: xyz}
    current = {}
    order = []    # residue keys in file order
    res_names = {}
    n_models = 0
    file_atoms = []   # EVERY first-model atom line in order: (key, name, kept)

    def flush():
        nonlocal current, n_models
        if current:
            models.append(current)
            n_models += 1
            current = {}

    with _open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "MODEL ":
                flush()
            elif rec in ("ATOM  ", "HETATM"):
                resname = line[17:20].strip()
                name = line[12:16].strip()
                chain = line[21]
                try:
                    resseq = int(line[22:26])
                except ValueError:
                    continue
                icode = line[26]
                key = (chain, resseq, icode)
                altloc = line[16]
                element = (line[76:78].strip() or name[0]).upper()
                keep = (resname in R.THREE_TO_ONE
                        and altloc in (" ", "A")
                        and element not in ("H", "D"))
                if n_models == 0:
                    file_atoms.append((key, name, keep))
                if not keep:
                    continue
                if key not in current:
                    current[key] = {}
                    if n_models == 0 and key not in res_names:
                        order.append(key)
                        res_names[key] = resname
                xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
                current[key][name] = xyz
            elif rec == "ENDMDL":
                flush()
    flush()

    if not models or not order:
        raise PDBParseError(f"no protein atoms parsed from {path}")
    if model_index is not None:
        models = [models[model_index]]
    if return_topology:
        return models, order, res_names, file_atoms

    return _build_struct(models, order, res_names, path)


def _build_struct(models, order, res_names, path=""):
    # keep only residues present with a CA in the first model
    order = [k for k in order if "CA" in models[0].get(k, {})]
    n_res = len(order)
    if n_res < 3:
        raise PDBParseError(f"need >= 3 residues, got {n_res}")

    chain_ids_raw = [k[0] for k in order]
    chain_map = {c: i for i, c in enumerate(dict.fromkeys(chain_ids_raw))}
    chain_id_og = np.array([chain_map[c] for c in chain_ids_raw], np.int32)
    res_type_og = np.array([R.restype_index(res_names[k]) for k in order], np.int32)

    F = len(models)
    cg = np.zeros((F, n_res, 3), np.float32)
    xyz14 = np.zeros((F, n_res - 2, R.MAX_ATOMS, 3), np.float32)
    mask14 = np.zeros((n_res - 2, R.MAX_ATOMS), bool)

    for fidx, model in enumerate(models):
        for i, key in enumerate(order):
            atoms = model.get(key, {})
            if "CA" in atoms:
                cg[fidx, i] = atoms["CA"]
            if 1 <= i <= n_res - 2:
                rt = res_type_og[i]
                for slot in range(int(R.RES_NATOMS[rt])):
                    nm = R.ATOM14_NAMES[rt, slot]
                    if nm in atoms:
                        xyz14[fidx, i - 1, slot] = atoms[nm]
                        if fidx == 0:
                            mask14[i - 1, slot] = True

    return {
        "res_type_og": res_type_og,
        "chain_id_og": chain_id_og,
        "cg_xyz_og": cg,
        "xyz14": xyz14,
        "atom14_mask": mask14,
    }


def load_xtc_ensemble(pdb_path, xtc_paths, stride=1, max_frames=None):
    """Atlas-style trajectory ingestion: topology PDB + xtc replicas.

    Mirrors the reference's mdtraj path (reference: utils/
    protein_module.py:898 `md.load(traj_file, top=pdb_file)` with stride
    100 at train preprocessing, utils/dataset_module.py:148-160 with
    stride 10000 at test): xtc coordinates are nm, converted to Å (x10,
    protein_module.py:523), streamed frame-by-frame onto the topology's
    atom order, frames of all replicas concatenated.

    Returns the same struct dict as `parse_pdb`.
    """
    from codlad_tpu_torch.data.xtc import read_xtc

    models0, order, res_names, file_atoms = parse_pdb(
        pdb_path, return_topology=True)
    kept_idx = [i for i, (_, _, keep) in enumerate(file_atoms) if keep]
    kept_atoms = [(k, n) for (k, n, keep) in file_atoms if keep]

    models = []
    for xp in xtc_paths:
        traj = read_xtc(xp, stride=stride, max_frames=max_frames)
        xyz = traj["xyz"] * 10.0   # nm -> Å
        if xyz.shape[1] != len(file_atoms):
            raise PDBParseError(
                f"{xp}: {xyz.shape[1]} atoms vs topology "
                f"{len(file_atoms)} in {pdb_path}")
        sel = xyz[:, kept_idx]
        for f in range(sel.shape[0]):
            model = {}
            for (key, name), p in zip(kept_atoms, sel[f]):
                model.setdefault(key, {})[name] = (
                    float(p[0]), float(p[1]), float(p[2]))
            models.append(model)
        if max_frames is not None and len(models) >= max_frames:
            models = models[:max_frames]
            break
    if not models:
        raise PDBParseError(f"no xtc frames loaded for {pdb_path}")
    return _build_struct(models, order, res_names, pdb_path)


def write_pdb(path, res_type_og, chain_id_og, xyz14_frames, cg_xyz_og=None):
    """Write modeled residues (atom14 frames) as a multi-MODEL PDB.

    xyz14_frames: [F, L, 14, 3] for the L = R-2 modeled residues.
    """
    res_type = res_type_og[1:-1]
    chain_id = chain_id_og[1:-1]
    L = len(res_type)
    frames = np.asarray(xyz14_frames)
    chain_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"

    with open(path, "w") as f:
        for fi, frame in enumerate(frames):
            f.write(f"MODEL     {fi + 1:4d}\n")
            serial = 1
            for i in range(L):
                rt = int(res_type[i])
                three = R.IDX_TO_THREE[rt]
                for slot in range(int(R.RES_NATOMS[rt])):
                    nm = R.ATOM14_NAMES[rt, slot]
                    x, y, z = frame[i, slot]
                    elem = nm[0] if not nm.startswith("SE") else "SE"
                    # standard columns: name 13-16, altLoc 17, resName 18-20,
                    # chain 22, resSeq 23-26, iCode 27, x from 31 (1-indexed)
                    f.write(
                        f"ATOM  {serial:5d} {nm:<4s} {three:>3s} "
                        f"{chain_letters[int(chain_id[i]) % 26]}{i + 2:4d}    "
                        f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                        f"          {elem:>2s}\n")
                    serial += 1
            f.write("ENDMDL\n")
        f.write("END\n")
