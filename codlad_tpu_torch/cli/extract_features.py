"""Stage bridge CLI: the frozen Stage-1 encoder over protein shards -> per-protein
latent features and their normalisation stats.

Twin of codlad_tpu/cli/extract_features.py for the vqvae mode: the pre-VQ
encoder latents of every frame of every shard, from a run of the port's
Stage-1 trainer (`--ckpt <logdir>`: config.json and best.pt, else last.pt),
written per protein under the shard's own name (`latents`, `res_mask`,
`res_type`, `cg_xyz_og`, `ic`, `prot_idx`), as the Stage-2 trainers of both
packages read them (`FeatureDataset`); with `--stats_name`, the channel
mean and std over the valid residues as `{stats_dir}/{name}_stats.npz`; and
the codebook's usage over those residues (`codebook_usage.npy`, `.csv`)
and a `manifest.json`.

    python -m codlad_tpu_torch.cli.extract_features --ckpt results/vq \
        --data_dir shards/train --out_dir features/train --stats_name PED_N6

It runs on the card (`--device cuda`, the default; it exits non-zero
without one) or, with `--device cpu`, on the kernels' plain versions. The
usage histogram's PNG and the fgvae/cgvae modes (`--learn_sigma`) are not
ported.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np
import torch

# the keys the encoder reads
ENC_KEYS = ("res_type", "atom_mask", "xyz14", "cg_xyz_og", "res_mask", "atom_edges",
            "atom_edges_mask", "cg_edges", "cg_edges_mask")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--stats_name", type=str, default=None,
                   help="if set, save channel mean/std as this name")
    p.add_argument("--stats_dir", type=str, default="datasets/miu_and_sigma")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("extract_features: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        raise SystemExit(1)
    from codlad_tpu_torch.cli.test import load_vae_ckpt
    from codlad_tpu_torch.data.norm import compute_stats, save_stats
    from codlad_tpu_torch.data.shards import ShardDataset, load_protein_shard
    from codlad_tpu_torch.models.vq import nearest_code

    vae, codebook, cfg = load_vae_ckpt(args.ckpt, dev)
    print(f"loaded {cfg['checkpoint']} checkpoint (step {cfg['step']})")
    files = ShardDataset(args.data_dir, args.batch_size, shuffle=False).files
    os.makedirs(args.out_dir, exist_ok=True)
    usage = np.zeros(codebook.shape[0], np.int64)
    all_latents, all_masks = [], []
    B = args.batch_size
    for fname in files:
        _, shard = load_protein_shard(os.path.join(args.data_dir, fname))
        n = shard["res_type"].shape[0]
        hs = []
        for i0 in range(0, n, B):
            # chunks of a constant batch shape: the last is padded with its
            # final frame repeated
            nb = min(B, n - i0)
            sl = {k: shard[k][i0:i0 + B] for k in ENC_KEYS}
            if nb < B:
                sl = {k: np.concatenate([v, np.repeat(v[-1:], B - nb, axis=0)])
                      for k, v in sl.items()}
            with torch.no_grad():
                h = vae.encode({k: torch.as_tensor(v, device=dev) for k, v in sl.items()})
            hs.append(h[:nb].float().cpu().numpy())
        h = np.concatenate(hs, axis=0)
        mask = shard["res_mask"]
        np.savez_compressed(os.path.join(args.out_dir, fname), latents=h.astype(np.float32),
                            res_mask=mask, res_type=shard["res_type"],
                            cg_xyz_og=shard["cg_xyz_og"], ic=shard["ic"],
                            prot_idx=shard["prot_idx"])
        all_latents.append(h)
        all_masks.append(mask)
        with torch.no_grad():
            idx = nearest_code(codebook, torch.as_tensor(h.reshape(-1, h.shape[-1]),
                                                         device=dev)).cpu().numpy()
        usage += np.bincount(idx[mask.reshape(-1).astype(bool)], minlength=len(usage))
        print(f"{fname}: {h.shape}", flush=True)

    if args.stats_name:
        mean, std = compute_stats(all_latents, all_masks)
        save_stats(args.stats_dir, args.stats_name, mean, std)
        print(f"stats {args.stats_name}: mean={mean} std={std}")
    active = int((usage > 0).sum())
    np.save(os.path.join(args.out_dir, "codebook_usage.npy"), usage)
    with open(os.path.join(args.out_dir, "codebook_usage.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["code", "count"])
        w.writerows([i, int(c)] for i, c in enumerate(usage))
    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump({"files": files, "codebook_active": active}, f, indent=2)
    print(f"codebook usage: {active}/{len(usage)} codes active")
    return usage


if __name__ == "__main__":
    main()
