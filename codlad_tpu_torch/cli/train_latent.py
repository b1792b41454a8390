"""Stage-2 trainer: latent diffusion over extracted features, one device.

Counterpart of codlad_tpu/cli/train_latent.py for `--model diffusion`:
AdamW with warmup -> linear-decay LR, grad clip, EMA, bf16 mixed precision,
dropout (the encoder's edge dropout runs in the K5 kernels in trunk mode;
with `--adaln_mode residual` the edge messages come from K6), steps/s logging
and `last` checkpoints in torch's format. Runs on the card unless
`--device cpu` is given; without a CUDA device it exits non-zero.

Usage:
  python -m codlad_tpu_torch.cli.train_latent --feature_dir features/train \\
      --exp results/latent_torch --latent_size 3 --stats_name PED_N6 \\
      --stats_dir datasets/miu_and_sigma --lr 3e-4 --warmup 80000 \\
      --batch_size 96 --bf16
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from codlad_tpu_torch.data.norm import load_stats, normalize
from codlad_tpu_torch.data.shards import iter_padded_batches


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--exp", type=str, default="results/latent_torch")
    p.add_argument("--feature_dir", type=str, required=True)
    p.add_argument("--stats_name", type=str, default=None)
    p.add_argument("--stats_dir", type=str, default="datasets/miu_and_sigma")
    p.add_argument("--latent_size", type=int, default=3)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=80000)
    p.add_argument("--schedule_steps", type=int, default=None)
    p.add_argument("--final_lr", type=float, default=None)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="linear")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.6)
    p.add_argument("--adaln_mode", type=str, default="trunk", choices=["trunk", "residual"],
                   help="'trunk' reproduces the reference adaLN (the gates scale the "
                        "whole trunk); 'residual' gates each branch DiT-style, so every "
                        "layer is the identity at init")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="mixed precision: bf16 network over f32 master params "
                        "(the diffusion math stays f32)")
    p.add_argument("--log_step", type=int, default=100)
    p.add_argument("--save_step", type=int, default=5000)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; there is no fallback when it is missing")
    return p


class FeatureDataset:
    """Batches of latents and their conditioning from the feature files
    (`latents` or `mu`/`sigma`, `res_type`, `cg_xyz_og`, `res_mask`), one
    process. With `mu` and `sigma` a fresh x1 = mu + sigma * eps is drawn
    every epoch. Files and rows are shuffled each epoch from `seed`."""

    def __init__(self, directory, batch_size, seed=0):
        self.directory = directory
        self.files = sorted(f for f in os.listdir(directory)
                            if f.endswith(".npz") and f != "manifest.npz")
        if not self.files:
            raise FileNotFoundError(f"no feature files (*.npz) under {directory}")
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        files = list(self.files)
        self._rng.shuffle(files)
        for fname in files:
            z = np.load(os.path.join(self.directory, fname))
            if "mu" in z and "sigma" in z:
                mu, sigma = z["mu"], z["sigma"]
                x1 = mu + sigma * self._rng.standard_normal(mu.shape).astype(mu.dtype)
            else:
                x1 = z["latents"]
            idx = self._rng.permutation(x1.shape[0])
            data = {"x1": x1, "res_type": z["res_type"],
                    "cg_xyz": z["cg_xyz_og"][:, 1:-1], "mask": z["res_mask"]}
            yield from iter_padded_batches(data, self.batch_size, idx)


def step_seed(seed, step):
    """The integer seed of one training step (t, noise and dropout masks)."""
    return (seed * 1_000_003 + step) % (2 ** 31)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_latent: no CUDA device (--device cpu trains on the CPU)")
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.train.checkpoints import CheckpointManager
    from codlad_tpu_torch.train.logging_utils import MetricsSink, create_logger
    from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
    from codlad_tpu_torch.train.steps import make_latent_step

    dev = torch.device(args.device)
    logger = create_logger(args.exp)
    sink = MetricsSink(args.exp)
    ckpt = CheckpointManager(args.exp)
    ckpt.save_config(vars(args))
    logger.info(f"args: {vars(args)}")

    if args.stats_name:
        mean, std = load_stats(args.stats_dir, args.stats_name)
    else:
        mean = np.zeros(args.latent_size, np.float32)
        std = np.ones(args.latent_size, np.float32)
    data = FeatureDataset(args.feature_dir, args.batch_size, seed=args.seed)

    model = MPNNDenoiser(torch.Generator().manual_seed(args.seed),
                         input_size=args.latent_size, learn_sigma=True,
                         dropout=args.dropout, adaln_mode=args.adaln_mode).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {n_params:,}; device {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    sched = warmup_linear_schedule(args.lr, args.warmup, args.schedule_steps, args.final_lr)
    state = TrainState(dict(model.named_parameters()), sched, grad_clip=args.grad_clip)
    process = create_diffusion(None, noise_schedule=args.noise_schedule, learn_sigma=True,
                               diffusion_steps=args.diffusion_steps)
    train_step, _ = make_latent_step(
        model, process, ema_decay=args.ema_decay, dropout=args.dropout > 0,
        compute_dtype=torch.bfloat16 if args.bf16 else None)

    log_t0, log_steps, stop = time.time(), 0, False
    for epoch in range(args.epochs):
        for hb in data:
            x1 = torch.as_tensor(normalize(hb["x1"], mean, std).astype(np.float32),
                                 device=dev)
            extras = {k: torch.as_tensor(hb[k], device=dev)
                      for k in ("res_type", "cg_xyz", "mask")}
            state, metrics = train_step(state, x1, extras, step_seed(args.seed, state.step))
            log_steps += 1
            if state.step % args.log_step == 0:
                loss, mse = float(metrics["loss"]), float(metrics["mse"])
                gnorm = float(metrics["grad_norm"])
                rate = log_steps / (time.time() - log_t0)
                logger.info(f"epoch {epoch} step {state.step}: loss {loss:.5f} "
                            f"mse {mse:.5f} grad_norm {gnorm:.4f} steps/sec {rate:.3f}")
                sink.log({"loss": loss, "mse": mse, "grad_norm": gnorm,
                          "steps_per_sec": rate}, step=state.step)
                log_t0, log_steps = time.time(), 0
            if state.step % args.save_step == 0:
                ckpt.save(state, f"step_{state.step}")
                ckpt.save(state, "last")
            if args.max_steps and state.step >= args.max_steps:
                stop = True
                break
        if stop:
            break
    ckpt.save(state, "last")
    logger.info("training done")
    return state


if __name__ == "__main__":
    main()
