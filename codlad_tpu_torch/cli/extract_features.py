"""Stage bridge CLI: the frozen Stage-1 encoder over protein shards -> per-protein
latent features and their normalisation stats.

Twin of codlad_tpu/cli/extract_features.py: the pre-VQ latents of every
frame of every shard, from a run of the port's Stage-1 trainer (`--ckpt
<logdir>`: config.json and best.pt, else last.pt) or a converted weights
file (`--vae_weights`, as cli.test reads it), written per protein
under the shard's own name (`latents`, `res_mask`, `res_type`, `cg_xyz_og`,
`ic`, `prot_idx`), as the Stage-2 trainers of both packages read them
(`FeatureDataset`). In the fgvae and cgvae modes the latents are one draw
mu + sigma * eps, and `mu` and `sigma` are saved beside it, so that the
Stage-2 reader draws afresh every epoch; with `--learn_sigma` the latents
are the concatenation mu || sigma instead. With `--stats_name`, the channel
mean and std over the valid residues go to `{stats_dir}/{name}_stats.npz`.
The usage of the codebook over those residues, by the run's quantizer's
snap (every code of every stage or head), goes to `codebook_usage.npy`
(zeros where there is no VQ state: fsq and the modes without VQ, as in
JAX) and `.csv`, beside a `manifest.json`.

    python -m codlad_tpu_torch.cli.extract_features --ckpt results/vq \
        --data_dir shards/train --out_dir features/train --stats_name PED_N6

It runs on the card (`--device cuda`, the default; it exits non-zero
without one) or, with `--device cpu`, on the kernels' plain versions. The
usage histogram's PNG is not ported. The draw of a chunk of frames comes
from a generator seeded with crc32 of the file name xor the chunk's first
frame (JAX keys it with Python's `hash` of the name, which changes from
process to process).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import zlib

import numpy as np
import torch

# the keys the encoder reads
ENC_KEYS = ("res_type", "atom_mask", "xyz14", "cg_xyz_og", "res_mask", "atom_edges",
            "atom_edges_mask", "cg_edges", "cg_edges_mask")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", type=str, help="a logdir of the port's cli.train_vqvae")
    src.add_argument("--vae_weights", type=str,
                     help="a converted VQ-VAE .npz (scripts/export_flax_npz.py)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--stats_name", type=str, default=None,
                   help="if set, save channel mean/std as this name")
    p.add_argument("--stats_dir", type=str, default="datasets/miu_and_sigma")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learn_sigma", action="store_true", default=False,
                   help="save mu||sigma concat latents for the vae paths")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("extract_features: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        raise SystemExit(1)
    from codlad_tpu_torch.cli.test import load_vae_ckpt, load_vae_weights
    from codlad_tpu_torch.data.batch import compress_indices, decompress_indices, to_device
    from codlad_tpu_torch.data.norm import compute_stats, save_stats
    from codlad_tpu_torch.data.shards import ShardDataset, load_protein_shard

    if args.ckpt:
        vae, snap, cfg = load_vae_ckpt(args.ckpt, dev)
        print(f"loaded {cfg['checkpoint']} checkpoint (step {cfg['step']})")
    else:
        vae, snap, cfg = load_vae_weights(args.vae_weights, dev)
        print(f"loaded {args.vae_weights}")
    mode = cfg.get("train_section", "vqvae")
    if mode == "ivae":
        raise SystemExit("extract_features: a GenZProt (-train_section ivae) run has no "
                         "latents to extract")
    snap_fn = _snap_fn(snap)
    files = ShardDataset(args.data_dir, args.batch_size, shuffle=False).files
    os.makedirs(args.out_dir, exist_ok=True)
    usage = np.zeros(_n_codes(snap, cfg), np.int64)
    all_latents, all_masks = [], []
    B = args.batch_size
    for fname in files:
        _, shard = load_protein_shard(os.path.join(args.data_dir, fname))
        n = shard["res_type"].shape[0]
        hs, mus, sigmas = [], [], []
        for i0 in range(0, n, B):
            # chunks of a constant batch shape: the last is padded with its
            # final frame repeated
            nb = min(B, n - i0)
            sl = {k: shard[k][i0:i0 + B] for k in ENC_KEYS}
            if nb < B:
                sl = {k: np.concatenate([v, np.repeat(v[-1:], B - nb, axis=0)])
                      for k, v in sl.items()}
            with torch.no_grad():
                h, mu, sigma = vae.encode_full(
                    decompress_indices(to_device(compress_indices(sl), dev)))
                if mode in ("fgvae", "cgvae"):
                    if args.learn_sigma:
                        h, mu = torch.cat([mu, sigma], dim=-1), None
                    else:
                        g = torch.Generator(dev).manual_seed(zlib.crc32(fname.encode()) ^ i0)
                        h = mu + sigma * torch.randn(sigma.shape, generator=g, device=dev)
            hs.append(h[:nb].float().cpu().numpy())
            if mu is not None:
                mus.append(mu[:nb].float().cpu().numpy())
                sigmas.append(sigma[:nb].float().cpu().numpy())
        h = np.concatenate(hs, axis=0)
        mask = shard["res_mask"]
        extra = ({"mu": np.concatenate(mus).astype(np.float32),
                  "sigma": np.concatenate(sigmas).astype(np.float32)} if mus else {})
        np.savez_compressed(os.path.join(args.out_dir, fname), latents=h.astype(np.float32),
                            res_mask=mask, res_type=shard["res_type"],
                            cg_xyz_og=shard["cg_xyz_og"], ic=shard["ic"],
                            prot_idx=shard["prot_idx"], **extra)
        all_latents.append(h)
        all_masks.append(mask)
        if snap_fn is not None:
            with torch.no_grad():
                idx = snap_fn(torch.as_tensor(h.reshape(-1, h.shape[-1]), device=dev))
            idx = idx.cpu().numpy()[mask.reshape(-1).astype(bool)]
            usage += np.bincount(idx.reshape(-1), minlength=len(usage))
        print(f"{fname}: {h.shape}", flush=True)

    if args.stats_name:
        mean, std = compute_stats(all_latents, all_masks)
        save_stats(args.stats_dir, args.stats_name, mean, std)
        print(f"stats {args.stats_name}: mean={mean} std={std}")
    active = int((usage > 0).sum())
    np.save(os.path.join(args.out_dir, "codebook_usage.npy"), usage)
    if snap_fn is not None:
        with open(os.path.join(args.out_dir, "codebook_usage.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["code", "count"])
            w.writerows([i, int(c)] for i, c in enumerate(usage))
    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump({"files": files, "codebook_active": active}, f, indent=2)
    if snap_fn is not None:
        print(f"codebook usage: {active}/{len(usage)} codes active")
    return usage


def _snap_fn(snap):
    """z [N, D] -> code indices [N, n] of the run's quantizer, or None where
    it has no state (fsq, the modes without VQ)."""
    if snap["vq_state"] is None:
        return None
    return lambda z: snap["quantizer"].snap(snap["vq_state"], z)[1]


def _n_codes(snap, cfg):
    """The usage histogram's length: the run's codebook size (JAX's), or the
    quantizer's own where the alias multiplies it (JAX's histogram stays at
    the configured size and fails on a code past it)."""
    n = cfg.get("codebook_size", 4096)
    q = snap["quantizer"]
    return max(n, q.codebook_size) if q is not None and q.kind != "fsq" else n


if __name__ == "__main__":
    main()
