"""Preprocessing CLI: PDB structures (or XTC ensembles) -> featurized .npz shards.

Twin of codlad_tpu/cli/preprocess.py (reference: extract_features.py:93-178
`--process_data`): reads one PDB file a protein (multi-MODEL ensembles), or
with `--xtc_dir` its topology PDB and its `{id}*.xtc` replicas at
`--stride` (Atlas-style, reference protein_module.py:898), featurizes every
frame, pads it to the protein's PadSpec and writes one shard a protein; a
protein that fails is recorded in `manifest.json` with its error, and the
run goes on. `--synthetic N_PROT N_RES N_FRAMES` writes the dataset-free
synthetic proteins instead. At the end the shards of each length bucket are
re-padded to one spec (`align_shard_buckets`). Host-only (numpy and the
port's native library); the shards are those of the JAX CLI.

    python -m codlad_tpu_torch.cli.preprocess --pdb_dir DIR --out_dir OUT \\
        [--split_file ids.txt] [--xtc_dir XTC --stride 100] [--max_frames N]
    python -m codlad_tpu_torch.cli.preprocess --synthetic 4 64 32 --out_dir OUT
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pdb_dir", type=str, default=None)
    p.add_argument("--split_file", type=str, default=None,
                   help="text file of protein ids (one per line)")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--xtc_dir", type=str, default=None,
                   help="directory of Atlas-style xtc replicas: each protein id needs "
                        "{id}.pdb (topology) in --pdb_dir and {id}*.xtc here")
    p.add_argument("--stride", type=int, default=100,
                   help="xtc frame stride (reference Atlas train convention: 100)")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--atom_cutoff", type=float, default=9.0)
    p.add_argument("--cg_cutoff", type=float, default=21.0)
    p.add_argument("--edgeorder", type=int, default=2)
    p.add_argument("--synthetic", type=int, nargs=3, default=None,
                   metavar=("N_PROT", "N_RES", "N_FRAMES"))
    p.add_argument("--structured", action="store_true",
                   help="synthetic mode: the learnable rotamer-mode generator instead of "
                        "i.i.d. torsions")
    p.add_argument("--res_range", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                   help="synthetic mode: each protein's length uniform in [LO, HI]")
    p.add_argument("--seed", type=int, default=0)
    return p


def _read(path, name, args):
    from codlad_tpu_torch.data.pdb import load_xtc_ensemble, parse_pdb

    if not args.xtc_dir:
        return parse_pdb(path)
    xtcs = sorted(glob.glob(os.path.join(args.xtc_dir, f"{name}*.xtc")))
    if not xtcs:
        raise FileNotFoundError(f"no xtc replicas for {name} in {args.xtc_dir}")
    return load_xtc_ensemble(path, xtcs, stride=args.stride, max_frames=args.max_frames)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    from codlad_tpu_torch.data.featurize import FeaturizeConfig
    from codlad_tpu_torch.data.shards import (align_shard_buckets, preprocess_structure,
                                              save_protein_shard)
    from codlad_tpu_torch.data.synthetic import synthetic_examples

    if not args.synthetic and args.pdb_dir is None:
        p.error("--pdb_dir or --synthetic required")
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = FeaturizeConfig(atom_cutoff=args.atom_cutoff, cg_cutoff=args.cg_cutoff,
                          bond_order=args.edgeorder)
    success, failed = [], []
    if args.synthetic:
        n_prot, n_res, n_frames = args.synthetic
        lens_rng = np.random.default_rng(args.seed + 991)
        for i in range(n_prot):
            ni = (int(lens_rng.integers(args.res_range[0], args.res_range[1] + 1))
                  if args.res_range else n_res)
            exs = synthetic_examples(n_frames, ni, seed=args.seed + i, cfg=cfg, prot_idx=i,
                                     structured=args.structured)
            save_protein_shard(os.path.join(args.out_dir, f"prot_{i:04d}.npz"), exs)
            success.append(f"prot_{i:04d}")
            print(f"[{i + 1}/{n_prot}] synthetic prot_{i:04d}: {n_frames} frames, {ni} "
                  f"residues{' (structured)' if args.structured else ''}", flush=True)
    else:
        if args.split_file:
            with open(args.split_file) as f:
                ids = [ln.strip() for ln in f if ln.strip()]
            files = [os.path.join(args.pdb_dir, f"{i}.pdb") for i in ids]
        else:
            files = sorted(os.path.join(args.pdb_dir, f) for f in os.listdir(args.pdb_dir)
                           if f.endswith((".pdb", ".pdb.gz")))
        for i, path in enumerate(files):
            name = os.path.basename(path).split(".")[0]
            try:
                exs = preprocess_structure(_read(path, name, args), prot_idx=i, cfg=cfg,
                                           max_frames=args.max_frames)
                save_protein_shard(os.path.join(args.out_dir, f"{name}.npz"), exs)
                success.append(name)
                print(f"[{i + 1}/{len(files)}] {name}: {len(exs)} frames ok", flush=True)
            except Exception as e:  # a protein that fails is recorded; the run goes on
                failed.append({"name": name, "error": f"{type(e).__name__}: {e}"})
                print(f"[{i + 1}/{len(files)}] {name}: FAILED {e}", file=sys.stderr, flush=True)
    if success:
        merged = align_shard_buckets(args.out_dir)
        print(f"bucket alignment: {len(merged)} bucket(s) for {len(success)} protein(s)")
    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump({"success": success, "failed": failed, "config": vars(args)}, f, indent=2,
                  default=str)
    print(f"done: {len(success)} ok, {len(failed)} failed")
    return {"success": success, "failed": failed}


if __name__ == "__main__":
    main()
