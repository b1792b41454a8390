"""Evaluation CLI: `--experiment latent`, `prior`, `recon` and `genzprot` over
a directory of protein shards.

Twin of codlad_tpu/cli/test.py. The VQ-VAE comes either from one converted
weights file (`--vae_weights`: flax-named params, codebook and config;
scripts/export_flax_npz.py writes it from an orbax checkpoint, because
nothing on the card reads orbax) or from a run of the port's Stage-1
trainer (`--vae_ckpt <logdir>`: its config.json and best.pt, else last.pt).
The Stage-2 denoiser of `latent` comes likewise from a converted file
(`--latent_weights`, `scripts/export_flax_npz.py --kind latent`) or from a
logdir of the port's cli/train_latent.py (`--latent_ckpt`); `--use_ema`
(the default) takes its EMA weights.

Per protein, the first --batch_size frames are scored:
* latent: --num_ensemble draws of `--num_sampling_steps` respaced steps of
  the denoiser (ancestral, or `--sampler ddim` at `--ddim_eta`; for a flow
  `--model` the ODE from noise by `--method` euler, midpoint, rk4 or dopri5
  (at `--rtol` / `--atol`, within 4 x --num_sampling_steps attempts); guided
  by classifier-free guidance at `--cfg_scale` != 0, against the null
  residue token), in bf16 unless `--no-bf16`, de-normalised with
  --stats_name/--stats_dir (identity without), snapped to the codebook,
  decoded and scored; the members' mean per metric, DIV, and every
  member's metrics (`per_ensemble`);
* prior: the same with N(0, I) latents in normalised space in place of
  the sampler (the diffusion prior with zero denoising steps): the
  no-model floor that brackets what Stage 2 contributes;
* recon: the encoder's latents, normalised, snapped, decoded and scored;
* genzprot (a `-train_section ivae` run of the Stage-1 trainer as
  --vae_ckpt): --num_ensemble draws from GenZProt's CG prior, decoded and
  scored as `latent`'s are.
The Stage-1 model is rebuilt from its config: every VAE mode and
`predict_angle`, and the exact quantizer it trained with (rvq and
multihead carry a codebook a stage or head, fsq none), through which
`latent`, `prior` and `recon` snap their latents (no snap for fsq and the
modes without VQ, as in JAX).
The per-protein metrics and their mean and std over proteins go to
`{out_dir}/summary_stats.json` with the JAX CLI's keys. `--save_pdb` and
`--save_xtc` write each protein's ensemble of its first frame as
`{name}_gen.pdb` (multi-MODEL) and `{name}_gen.xtc` (nm), and recon's
decoded frames as `{name}_recon.pdb`, with the JAX CLI's writers
(data/pdb.py, data/xtc.py).

    python -m codlad_tpu_torch.cli.test --experiment latent \
        --vae_weights weights/convergence_vqvae.npz \
        --latent_weights weights/convergence_latent.npz \
        --stats_name CONV --stats_dir weights --data_dir shards/val \
        --out_dir results/eval_latent --num_sampling_steps 100 --num_ensemble 10
    python -m codlad_tpu_torch.cli.test --experiment recon --vae_ckpt results/vq \
        --data_dir shards/val --out_dir results/eval_recon

It runs on the card (`--device cuda`, the default; it exits non-zero
without one) or, with `--device cpu`, on the kernels' plain versions.
As the JAX CLI does, the sampling process is built without the run's
`self_condition` and `predict_xstart`: a self-conditioned denoiser gets
zeros as x_self_cond at every step, and an x_start-predicting one is read
as predicting eps.
A distilled checkpoint (cli/distill.py; `distill_tmap` in its config)
samples on the student's own grid (gen/diffusion.diffusion_from_tmap),
ignoring --num_sampling_steps with a note, and with the DDIM sampler unless
`--sampler` says otherwise; any other checkpoint defaults to ancestral.
`--seq_shards S` samples sequence-parallel (eval/harness.py `seq`): run
under torchrun with S ranks (NCCL on cards, gloo with --device cpu), or
with S = 1 in one process; every rank draws the same members and rank 0
alone prints and writes. As in JAX, the
denoiser's output width follows the run config's `model` (2C for diffusion
and sbcfm) and the process follows `--model`; an sbcfm denoiser cannot be
integrated (its 2C channels do not fit the C-channel state), and the draw
raises where the JAX CLI's fails. Member s
of an ensemble draws from torch.Generator(device).manual_seed(seed + s),
so the port's draws are not the JAX package's.
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
    p.add_argument("--experiment", default="latent",
                   choices=["recon", "latent", "genzprot", "prior"])
    p.add_argument("--model", default="diffusion",
                   choices=["diffusion", "fm", "icfm", "vpfm", "otcfm", "sbcfm"])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--vae_weights", help="npz of flax-named VQ-VAE params, codebook and config")
    src.add_argument("--vae_ckpt", help="logdir of the port's Stage-1 trainer "
                                        "(codlad_tpu_torch.cli.train_vqvae)")
    lat = p.add_mutually_exclusive_group()
    lat.add_argument("--latent_weights", help="npz of the flax-named Stage-2 params, EMA "
                                              "and config (scripts/export_flax_npz.py)")
    lat.add_argument("--latent_ckpt", help="logdir of the port's Stage-2 trainer "
                                           "(codlad_tpu_torch.cli.train_latent)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default="results/eval")
    p.add_argument("--num_sampling_steps", type=int, default=100)
    p.add_argument("--num_ensemble", type=int, default=10)
    p.add_argument("--cfg_scale", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--method", default="euler", choices=["euler", "midpoint", "rk4", "dopri5"],
                   help="ODE solver of the flow models")
    p.add_argument("--rtol", type=float, default=1e-5, help="dopri5 relative tolerance")
    p.add_argument("--atol", type=float, default=1e-5, help="dopri5 absolute tolerance")
    p.add_argument("--sampler", default=None, choices=["ancestral", "ddim"],
                   help="default: ddim for a distilled checkpoint, else ancestral")
    p.add_argument("--ddim_eta", type=float, default=0.0,
                   help="DDIM stochasticity (0 = deterministic)")
    p.add_argument("--seq_shards", type=int, default=0,
                   help="shard each protein's residues over this many ranks (torchrun "
                        "with that many processes)")
    p.add_argument("--stats_name", default=None)
    p.add_argument("--stats_dir", default="datasets/miu_and_sigma")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction, default=True,
                   help="--no-use_ema evaluates the raw (non-EMA) Stage-2 weights")
    p.add_argument("--save_pdb", action="store_true", default=False,
                   help="write the ensembles as multi-MODEL PDB (reference test.py:804-816)")
    p.add_argument("--save_xtc", action="store_true", default=False,
                   help="write the ensembles as xtc trajectories (reference test.py:787-803)")
    p.add_argument("--doubled_batch", action="store_true", default=False,
                   help="reproduce the reference's doubled-batch sampling")
    p.add_argument("--ensemble_fold", type=int, default=1,
                   help="ensemble members drawn per sampler call by tiling the batch "
                        "(other noise streams than unfolded members)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="the denoiser in bf16 (the conditioning from the rounded weights)")
    p.add_argument("--device", default="cuda")
    return p


def _vae_from_config(cfg):
    """The f32 Stage-1 model (random weights) of a run config, as the JAX CLI
    builds it for evaluation: GenZProt for `train_section` ivae, else the
    VAE of that mode (vqvae by default) and `predict_angle`."""
    from codlad_tpu_torch.models.vae import VAE, GenZProt

    gen = torch.Generator().manual_seed(0)
    common = dict(embed_dim=cfg.get("embed_dim", 36), n_rbf=cfg.get("n_rbf", 15),
                  dec_cutoff=cfg.get("cg_cutoff", 21.0), dec_nconv=cfg.get("dec_nconv", 4),
                  enc_nconv=cfg.get("enc_nconv", 3), atom_cutoff=cfg.get("atom_cutoff", 9.0),
                  cg_cutoff=cfg.get("cg_cutoff", 21.0))
    mode = cfg.get("train_section", "vqvae")
    if mode == "ivae":
        return GenZProt(gen, **common)
    return VAE(gen, mode=mode, vqdim=cfg.get("vqdim", 3),
               predict_angle=cfg.get("predict_angle", False), **common)


def _snap_of(cfg, tree, device):
    """{quantizer, vq_state} of a run config and its saved VQ state tree:
    the run's Quantizer and its state (None for fsq); nothing for the modes
    without VQ."""
    from codlad_tpu_torch.models.vq import load_state_tree, quantizer_from_config

    quantizer = quantizer_from_config(cfg)
    if quantizer is None:
        return {"quantizer": None, "vq_state": None}
    state = quantizer.init(torch.Generator().manual_seed(0), device)
    load_state_tree(state, tree)
    return {"quantizer": quantizer, "vq_state": state}


def load_vae_weights(path, device):
    """(Stage-1 model in eval mode on `device`, {quantizer, vq_state} (see
    `_snap_of`), config) from a converted weights file; a plain EMA VQ's
    file may hold only its codebook."""
    from codlad_tpu_torch.convert.from_flax import load_flax, read_flax_npz
    from codlad_tpu_torch.models.vq import VQState

    w = read_flax_npz(path)
    model = load_flax(_vae_from_config(w["config"]), w["params"])
    tree = w["vq_state"]
    if tree is None and w["codebook"] is not None:
        tree = VQState.of_codebook(torch.as_tensor(w["codebook"])).tensors()
    snap = (_snap_of(w["config"], tree, device) if tree is not None
            else {"quantizer": None, "vq_state": None})
    return model.to(device).eval(), snap, w["config"]


def _restore_params(module, ckpt, key="params"):
    """Fill `module` from the `best` (else `last`) checkpoint of a port
    logdir, from its `key` tree; -> (checkpoint name, its state dict)."""
    name = "best" if ckpt.exists("best") else "last"
    sd = torch.load(ckpt.path(name), map_location="cpu", weights_only=True)
    params, saved = dict(module.named_parameters()), sd.get(key)
    if saved is None or set(params) != set(saved):
        raise KeyError(f"{ckpt.path(name)} does not hold this model's {key}: "
                       f"{sorted(set(params) ^ set(saved or {}))}")
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(saved[k])
    return name, sd


def load_vae_ckpt(logdir, device):
    """(Stage-1 model in eval mode on `device`, {quantizer, vq_state} (see
    `_snap_of`), config with the checkpoint's name and step)
    from a logdir of cli/train_vqvae.py: its config.json and `best`
    checkpoint, else `last`."""
    from codlad_tpu_torch.train.checkpoints import CheckpointManager

    ckpt = CheckpointManager(logdir)
    cfg = ckpt.load_config()
    model = _vae_from_config(cfg)
    name, sd = _restore_params(model, ckpt)
    snap = _snap_of(cfg, sd.get("vq_state"), device)
    return model.to(device).eval(), snap, dict(cfg, checkpoint=name, step=int(sd["step"]))


def genzprot_sample(model, generator, batch):
    """One GenZProt member: a draw from the CG prior (standard-normal eps from
    `generator`), decoded -> (ic, xyz14)."""
    from codlad_tpu_torch.geometry.internal import ic_to_xyz14

    res_type = batch["res_type"]
    eps = torch.randn(tuple(res_type.shape) + (model.embed_dim,), generator=generator,
                      device=res_type.device)
    z, _, _ = model.get_latent_cg(batch, eps)
    ic = model.decode(batch, z)
    return ic, ic_to_xyz14(batch["cg_xyz_og"], ic, batch["res_type"])


def load_latent_ckpt(logdir, device, use_ema=True, latent_size=3):
    """(MPNNDenoiser in eval mode on `device`, config) from a logdir of
    cli/train_latent.py: its config.json and `best` checkpoint, else `last`,
    with the EMA weights unless use_ema is False."""
    from codlad_tpu_torch.convert.from_flax import denoiser_from_config
    from codlad_tpu_torch.train.checkpoints import CheckpointManager

    ckpt = CheckpointManager(logdir)
    cfg = ckpt.load_config()
    model = denoiser_from_config(cfg, cfg.get("latent_size", latent_size))
    name, sd = _restore_params(model, ckpt, "ema_params" if use_ema else "params")
    return model.to(device).eval(), dict(cfg, checkpoint=name, step=int(sd["step"]))


def load_latent(args, device, latent_size):
    """(denoiser, its config) from --latent_weights or --latent_ckpt."""
    from codlad_tpu_torch.convert.from_flax import load_denoiser

    if args.latent_weights:
        model, cfg, _ = load_denoiser(args.latent_weights, device, args.use_ema, latent_size)
        return model, cfg
    if args.latent_ckpt:
        return load_latent_ckpt(args.latent_ckpt, device, args.use_ema, latent_size)
    raise SystemExit("test: --experiment latent needs --latent_weights or --latent_ckpt")


def export_ensembles(out_dir, fname, batch, structures, save_pdb, save_xtc):
    """The ensemble of a protein's first frame (structures [S, B, L, 14, 3]
    Å) as `{name}_gen.pdb` and / or `{name}_gen.xtc` (nm), as the JAX CLI's
    `_export_ensembles` writes them (reference test.py:787-816)."""
    from codlad_tpu_torch.data.pdb import write_pdb
    from codlad_tpu_torch.data.xtc import write_xtc
    from codlad_tpu_torch.geometry import residues as R

    base = fname.replace(".npz", "")
    n_valid = int(np.asarray(batch["res_mask"][0].cpu()).sum())
    res_type = np.asarray(batch["res_type"][0].cpu())[:n_valid]
    frames = structures[:, 0, :n_valid]
    if save_pdb:
        og_res = np.concatenate([res_type[:1], res_type, res_type[-1:]])
        write_pdb(os.path.join(out_dir, f"{base}_gen.pdb"), og_res, np.zeros_like(og_res),
                  frames)
    if save_xtc:
        write_xtc(os.path.join(out_dir, f"{base}_gen.xtc"),
                  frames[:, R.ATOM14_EXISTS[res_type]] / 10.0)


def write_recon_pdb(out_dir, fname, batch, xyz14):
    """recon's decoded frames as `{name}_recon.pdb` (the JAX CLI's recon
    export: the first frame's sequence, every frame a MODEL)."""
    from codlad_tpu_torch.data.pdb import write_pdb

    rt = np.asarray(batch["res_type"].cpu())
    og_res = np.concatenate([rt[:, :1], rt, rt[:, -1:]], axis=1)[0]
    write_pdb(os.path.join(out_dir, fname.replace(".npz", "_recon.pdb")), og_res,
              np.zeros_like(og_res), np.asarray(xyz14.cpu()))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from codlad_tpu_torch.data.norm import load_stats
    from codlad_tpu_torch.data.shards import ShardDataset, load_protein_shard
    from codlad_tpu_torch.eval.harness import (SamplingPipeline, evaluate_structures,
                                               run_ensemble)
    from codlad_tpu_torch.gen.diffusion import create_diffusion, diffusion_from_tmap
    from codlad_tpu_torch.gen.flow import FLOW_MATCHERS
    from codlad_tpu_torch.train import mesh as mesh_mod

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("test: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        sys.exit(1)
    device = mesh_mod.rank_device(args.device)
    seq = None
    if args.seq_shards:
        mesh_mod.maybe_init_distributed(device)
        mesh = mesh_mod.make_mesh(args.seq_shards, seq_mode=True)
        if mesh.data != 1:
            raise SystemExit(f"--seq_shards {args.seq_shards} needs as many ranks, not "
                             f"{mesh.world}")
        seq = mesh.seq_ctx()
    main_rank = mesh_mod.is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    os.makedirs(args.out_dir, exist_ok=True)
    load = load_vae_ckpt if args.vae_ckpt else load_vae_weights
    vae, snap, cfg = load(args.vae_ckpt or args.vae_weights, device)
    genzprot = cfg.get("train_section") == "ivae"
    if (args.experiment == "genzprot") != genzprot:
        raise SystemExit("test: --experiment genzprot takes a GenZProt (-train_section ivae) "
                         "checkpoint, and only it does")
    latent_size = cfg.get("vqdim", 3)
    if args.stats_name:
        mean, std = load_stats(args.stats_dir, args.stats_name)
    else:
        mean, std = np.zeros(latent_size, np.float32), np.ones(latent_size, np.float32)
    denoiser = process = None
    if args.experiment == "latent":
        denoiser, lat_cfg = load_latent(args, device, latent_size)
        tmap = lat_cfg.get("distill_tmap")
        if args.model == "diffusion" and tmap:
            # a distilled student samples on its own grid (teacher grid[0::2]^k)
            if args.num_sampling_steps != len(tmap):
                say(f"note: distilled checkpoint has a fixed {len(tmap)}-step grid; "
                    f"ignoring --num_sampling_steps {args.num_sampling_steps}")
            process = diffusion_from_tmap(
                tmap, noise_schedule=lat_cfg.get("noise_schedule", "linear"),
                diffusion_steps=lat_cfg.get("diffusion_steps", 1000), learn_sigma=True)
        elif args.model == "diffusion":
            process = create_diffusion(str(args.num_sampling_steps),
                                       diffusion_steps=lat_cfg.get("diffusion_steps", 1000),
                                       learn_sigma=True)
        else:
            process = FLOW_MATCHERS[args.model]()
        if args.sampler is None:
            args.sampler = "ddim" if args.model == "diffusion" and tmap else "ancestral"
    pipe = SamplingPipeline(denoiser=denoiser, process=process, vae=vae, codebook=None, **snap,
                            norm_mean=mean, norm_std=std, latent_size=latent_size,
                            compute_dtype=torch.bfloat16 if args.bf16 else None,
                            sampler=args.sampler or "ancestral", ddim_eta=args.ddim_eta,
                            doubled_batch=args.doubled_batch, cfg_scale=args.cfg_scale,
                            process_kind=args.model, ode_steps=args.num_sampling_steps,
                            ode_method=args.method, ode_rtol=args.rtol, ode_atol=args.atol,
                            seq=seq)

    def prior_sample(generator, b):
        lat = torch.randn(tuple(b["res_type"].shape) + (latent_size,), generator=generator,
                          device=device)
        return pipe.decode(b, lat)

    data = ShardDataset(args.data_dir, args.batch_size, shuffle=False)
    summary = {}
    t_start = time.time()
    for fname in data.files:
        _, shard = load_protein_shard(os.path.join(args.data_dir, fname))
        n = min(shard["res_type"].shape[0], args.batch_size)
        batch = {k: torch.as_tensor(v[:n], device=device) for k, v in shard.items()}
        t0 = time.time()
        log_fn = (lambda s, m: say(f"  {fname} ensemble {s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in m.items()), flush=True))
        export = args.save_pdb or args.save_xtc
        if args.experiment == "recon":
            h = pipe.encode_latents(batch)
            ic, xyz14 = pipe.decode(batch, pipe.normalise(h))
            agg = {k: float(v) for k, v in evaluate_structures(batch, ic, xyz14).items()}
            if args.save_pdb and main_rank:
                write_recon_pdb(args.out_dir, fname, batch, xyz14)
        else:
            sample_fn = {"prior": prior_sample,
                         "genzprot": lambda g, b: genzprot_sample(vae, g, b)}.get(args.experiment)
            agg = run_ensemble(pipe, batch, args.num_ensemble, seed=args.seed,
                               sample_fn=sample_fn, log_fn=log_fn, fold=args.ensemble_fold,
                               return_structures=export)
            if export:
                agg, structures = agg
                if main_rank:
                    export_ensembles(args.out_dir, fname, batch, structures, args.save_pdb,
                                     args.save_xtc)
        agg["wallclock_sec"] = time.time() - t0
        summary[fname] = agg
        say(f"{fname}: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()
                                    if np.isscalar(v)), flush=True)

    # global mean and std over proteins (reference test.py:821-889)
    keys = [k for k, v in next(iter(summary.values())).items() if np.isscalar(v)]
    per_protein = {k: [v[k] for v in summary.values()] for k in keys}
    summary["__global__"] = {k: float(np.mean(vs)) for k, vs in per_protein.items()}
    summary["__global_stats__"] = {k: {"mean": float(np.mean(vs)), "std": float(np.std(vs))}
                                   for k, vs in per_protein.items()}
    summary["__global__"]["total_sec"] = time.time() - t_start
    if main_rank:
        with open(os.path.join(args.out_dir, "summary_stats.json"), "w") as f:
            json.dump(summary, f, indent=2)
    say("global:", json.dumps(summary["__global__"], indent=2))
    return summary


if __name__ == "__main__":
    main()
