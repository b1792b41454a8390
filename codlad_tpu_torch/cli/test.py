"""Evaluation CLI, `--experiment recon`: encode -> VQ snap -> decode ->
metrics over a directory of protein shards.

Twin of codlad_tpu/cli/test.py for its recon experiment. The VQ-VAE comes
either from one converted weights file (`--vae_weights`: flax-named params,
codebook and config; scripts/export_flax_npz.py writes it from an orbax
checkpoint, because nothing on the card reads orbax) or from a run of the
port's Stage-1 trainer (`--vae_ckpt <logdir>`: its config.json and best.pt,
else last.pt). Per protein, the first --batch_size frames
are encoded, normalised with --stats_name/--stats_dir (identity without),
de-normalised, snapped to the codebook, decoded and scored; the per-protein
metrics and their mean and std over proteins go to
`{out_dir}/summary_stats.json`, as the JAX CLI writes them.

    python -m codlad_tpu_torch.cli.test --experiment recon \
        --vae_weights weights/convergence_vqvae.npz --data_dir shards/val \
        --out_dir results/eval_recon [--stats_name CONV --stats_dir stats]
    python -m codlad_tpu_torch.cli.test --experiment recon --vae_ckpt results/vq \
        --data_dir shards/val --out_dir results/eval_recon

It runs on the card (`--device cuda`, the default; it exits non-zero
without one) or, with `--device cpu`, on the kernels' plain versions. The
`latent`, `genzprot` and `prior` experiments are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--experiment", default="recon", choices=["recon"])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--vae_weights", help="npz of flax-named VQ-VAE params, codebook and config")
    src.add_argument("--vae_ckpt", help="logdir of the port's Stage-1 trainer "
                                        "(codlad_tpu_torch.cli.train_vqvae)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default="results/eval")
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--stats_name", default=None)
    p.add_argument("--stats_dir", default="datasets/miu_and_sigma")
    p.add_argument("--device", default="cuda")
    return p


def _vae_from_config(cfg):
    """The f32 VAE (random weights) of a run config, as the JAX CLI builds it
    for evaluation; only the vqvae mode without predict_angle is ported."""
    from codlad_tpu_torch.models.vae import VAE

    mode = cfg.get("train_section", "vqvae")
    if mode != "vqvae" or cfg.get("predict_angle", False):
        raise ValueError(f"only the vqvae mode without predict_angle is ported, not {mode}")
    return VAE(torch.Generator().manual_seed(0), embed_dim=cfg.get("embed_dim", 36),
               vqdim=cfg.get("vqdim", 3), n_rbf=cfg.get("n_rbf", 15),
               dec_cutoff=cfg.get("cg_cutoff", 21.0), dec_nconv=cfg.get("dec_nconv", 4),
               enc_nconv=cfg.get("enc_nconv", 3), atom_cutoff=cfg.get("atom_cutoff", 9.0),
               cg_cutoff=cfg.get("cg_cutoff", 21.0))


def load_vae(path, device):
    """(VAE in eval mode on `device`, codebook tensor or None, config) from a
    converted weights file."""
    from codlad_tpu_torch.convert.from_flax import load_flax, read_flax_npz

    w = read_flax_npz(path)
    vae = load_flax(_vae_from_config(w["config"]), w["params"])
    codebook = w["codebook"]
    if codebook is not None:
        codebook = torch.as_tensor(codebook, dtype=torch.float32, device=device)
    return vae.to(device).eval(), codebook, w["config"]


def load_vae_ckpt(logdir, device):
    """(VAE in eval mode on `device`, codebook tensor, config) from a logdir
    of cli/train_vqvae.py: its config.json and `best` checkpoint, else
    `last`."""
    from codlad_tpu_torch.train.checkpoints import CheckpointManager

    ckpt = CheckpointManager(logdir)
    cfg = ckpt.load_config()
    vae = _vae_from_config(cfg)
    name = "best" if ckpt.exists("best") else "last"
    sd = torch.load(ckpt.path(name), map_location="cpu", weights_only=True)
    params = dict(vae.named_parameters())
    if set(params) != set(sd["params"]):
        raise KeyError(f"{ckpt.path(name)} does not hold this VAE's parameters: "
                       f"{sorted(set(params) ^ set(sd['params']))}")
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(sd["params"][k])
    codebook = sd["vq_state"]["codebook"].to(device=device, dtype=torch.float32)
    return vae.to(device).eval(), codebook, dict(cfg, checkpoint=name, step=int(sd["step"]))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from codlad_tpu_torch.data.norm import load_stats
    from codlad_tpu_torch.data.shards import ShardDataset, load_protein_shard
    from codlad_tpu_torch.eval.harness import SamplingPipeline, evaluate_structures

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("test: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        sys.exit(1)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.vae_ckpt:
        vae, codebook, cfg = load_vae_ckpt(args.vae_ckpt, device)
    else:
        vae, codebook, cfg = load_vae(args.vae_weights, device)
    latent_size = cfg.get("vqdim", 3)
    if args.stats_name:
        mean, std = load_stats(args.stats_dir, args.stats_name)
    else:
        mean, std = np.zeros(latent_size, np.float32), np.ones(latent_size, np.float32)
    pipe = SamplingPipeline(denoiser=None, process=None, vae=vae, codebook=codebook,
                            norm_mean=mean, norm_std=std, latent_size=latent_size)

    data = ShardDataset(args.data_dir, args.batch_size, shuffle=False)
    summary = {}
    t_start = time.time()
    for fname in data.files:
        _, shard = load_protein_shard(os.path.join(args.data_dir, fname))
        n = min(shard["res_type"].shape[0], args.batch_size)
        batch = {k: torch.as_tensor(v[:n], device=device) for k, v in shard.items()}
        t0 = time.time()
        h = pipe.encode_latents(batch)
        ic, xyz14 = pipe.decode(batch, pipe.normalise(h))
        agg = {k: float(v) for k, v in evaluate_structures(batch, ic, xyz14).items()}
        agg["wallclock_sec"] = time.time() - t0
        summary[fname] = agg
        print(f"{fname}: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()), flush=True)

    keys = list(next(iter(summary.values())))
    per_protein = {k: [v[k] for v in summary.values()] for k in keys}
    summary["__global__"] = {k: float(np.mean(vs)) for k, vs in per_protein.items()}
    summary["__global_stats__"] = {k: {"mean": float(np.mean(vs)), "std": float(np.std(vs))}
                                   for k, vs in per_protein.items()}
    summary["__global__"]["total_sec"] = time.time() - t_start
    with open(os.path.join(args.out_dir, "summary_stats.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("global:", json.dumps(summary["__global__"], indent=2))
    return summary


if __name__ == "__main__":
    main()
