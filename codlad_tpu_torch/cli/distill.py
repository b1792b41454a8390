"""Progressive distillation of a trained Stage-2 diffusion checkpoint.

Twin of codlad_tpu/cli/distill.py: each round trains a student, which
starts as the teacher, so that ONE student DDIM step matches TWO teacher
DDIM steps (gen/distill.py), then halves again: 100 -> 50 -> 25 -> 13 ->
... steps. The output directory is a latent checkpoint: `cli.test
--latent_ckpt` reads the `distill_tmap` in its config.json, rebuilds the
student's sampling grid and defaults to the DDIM sampler.

The teacher is `--teacher_ckpt`, a logdir of the port's cli.train_latent
(its `best.pt`, else `last.pt`; the EMA weights unless
--no-use_teacher_ema), or `--teacher_weights`, a converted `.npz`
(scripts/export_flax_npz.py --kind latent), as `cli.test --latent_weights`
reads it: nothing on the card reads the JAX trainer's orbax checkpoints.
A teacher that is not a diffusion model, or is self-conditioned, is
refused, as in JAX. Each round saves `T{steps}.pt` and `last.pt` and
writes config.json with `distilled`, `distill_tmap`, `distill_round` and
`teacher_ckpt`. `--fast_rng` (the TPU's hardware PRNG) has no counterpart
on the card and is accepted for config compatibility. Under torchrun the
rounds run data-parallel (train/mesh.py, as cli.train_latent); rank 0 alone
logs and saves. Step i draws its student indices and noise from
`step_seed(seed, i)` (cli/train_latent.py), counting over every round.

    python -m codlad_tpu_torch.cli.distill --teacher_ckpt results/latent \\
        --feature_dir features --exp results/distill --stats_name PED_N6 \\
        --start_steps 100 --rounds 3 --steps_per_round 20000 --batch_size 96 --bf16

It runs on the card (`--device cuda`, the default; it exits non-zero
without one) or, with `--device cpu`, on the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--exp", type=str, default="results/distill")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--teacher_ckpt", type=str,
                     help="a cli.train_latent logdir of the port (model diffusion)")
    src.add_argument("--teacher_weights", type=str,
                     help="a converted Stage-2 .npz (scripts/export_flax_npz.py --kind latent)")
    p.add_argument("--feature_dir", type=str, required=True)
    p.add_argument("--stats_name", type=str, default=None)
    p.add_argument("--stats_dir", type=str, default="datasets/miu_and_sigma")
    p.add_argument("--start_steps", type=int, default=100,
                   help="the teacher's sampling grid for round 1 (the production eval "
                        "respacing)")
    p.add_argument("--start_grid", type=str, default="ddim", choices=["ddim", "sections"],
                   help="round-1 grid: ddim stride or the reference's section respacing")
    p.add_argument("--rounds", type=int, default=3,
                   help="halvings: 100 -> 50 -> 25 -> 13 with 3 rounds")
    p.add_argument("--steps_per_round", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--use_teacher_ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--bf16", action="store_true", default=False)
    p.add_argument("--fast_rng", action=argparse.BooleanOptionalAction, default=True,
                   help="no counterpart on the card (the TPU's rbg PRNG)")
    p.add_argument("--log_step", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; there is no fallback when it is missing")
    return p


def _refuse(cfg):
    if cfg.get("model", "diffusion") != "diffusion":
        raise SystemExit(f"distillation needs a diffusion teacher (teacher model: "
                         f"{cfg.get('model')})")
    if cfg.get("self_condition"):
        raise SystemExit("self-conditioned teachers are not supported")


def load_teacher(args, device):
    """(teacher denoiser on `device`, its weights {name: f32 tensor}, its run
    config), refusing what JAX refuses."""
    from codlad_tpu_torch.convert.from_flax import denoiser_from_config, load_denoiser

    if args.teacher_weights:
        model, cfg, _ = load_denoiser(args.teacher_weights, device, args.use_teacher_ema)
        _refuse(cfg)
    else:
        from codlad_tpu_torch.cli.test import _restore_params
        from codlad_tpu_torch.train.checkpoints import CheckpointManager
        ckpt = CheckpointManager(args.teacher_ckpt)
        cfg = ckpt.load_config()
        _refuse(cfg)
        model = denoiser_from_config(cfg, cfg.get("latent_size", 3))
        _restore_params(model, ckpt, "ema_params" if args.use_teacher_ema else "params")
        model = model.to(device)
    return model, {k: v.detach().clone() for k, v in model.named_parameters()}, cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("distill: no CUDA device (--device cpu distills on the CPU)")
    from codlad_tpu_torch.cli.train_latent import FeatureDataset, step_seed
    from codlad_tpu_torch.data.norm import load_stats, normalize
    from codlad_tpu_torch.data.prefetch import prefetch
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.gen.distill import halve
    from codlad_tpu_torch.train import mesh as mesh_mod
    from codlad_tpu_torch.train.checkpoints import CheckpointManager
    from codlad_tpu_torch.train.logging_utils import create_logger
    from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
    from codlad_tpu_torch.train.steps import make_distill_step

    dev = mesh_mod.rank_device(args.device)
    mesh_mod.maybe_init_distributed(dev)
    mesh = mesh_mod.make_mesh(1)
    is_main = mesh_mod.is_main_process()
    logger = create_logger(args.exp, main=is_main)
    logger.info(f"args: {vars(args)}")

    model, teacher_params, tcfg = load_teacher(args, dev)
    teacher_src = args.teacher_ckpt or args.teacher_weights
    logger.info(f"teacher from {teacher_src}; {mesh.data} data rank(s)")
    latent_size = model.input_size
    if args.stats_name:
        mean, std = load_stats(args.stats_dir, args.stats_name)
    else:
        mean = np.zeros(latent_size, np.float32)
        std = np.ones(latent_size, np.float32)
    if args.batch_size % mesh.data:
        raise SystemExit(f"--batch_size {args.batch_size} must divide by the {mesh.data} "
                         "data ranks")
    data = FeatureDataset(args.feature_dir, args.batch_size // mesh.data, seed=args.seed,
                          process_index=mesh.data_rank, process_count=mesh.data)

    respacing = (f"ddim{args.start_steps}" if args.start_grid == "ddim"
                 else str(args.start_steps))
    teacher_diff = create_diffusion(respacing,
                                    noise_schedule=tcfg.get("noise_schedule", "linear"),
                                    diffusion_steps=tcfg.get("diffusion_steps", 1000),
                                    learn_sigma=True)
    ckpt = CheckpointManager(args.exp)

    def device_batches():
        for hb in data:
            x1 = torch.as_tensor(normalize(hb["x1"], mean, std).astype(np.float32), device=dev)
            yield x1, {k: torch.as_tensor(hb[k], device=dev)
                       for k in ("res_type", "cg_xyz", "mask")}

    step_total, state = 0, None
    for rnd in range(args.rounds):
        student_diff = halve(teacher_diff)
        Ts = student_diff.num_timesteps
        logger.info(f"round {rnd + 1}/{args.rounds}: {teacher_diff.num_timesteps} -> {Ts} "
                    "steps")
        sched = warmup_linear_schedule(args.lr, args.warmup, args.steps_per_round,
                                       args.lr * 0.1)
        # the student starts as the teacher, from a copy
        state = TrainState(teacher_params, sched, grad_clip=args.grad_clip)
        train_step, _ = make_distill_step(
            model, teacher_diff, student_diff, ema_decay=args.ema_decay,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
            mesh=mesh if torch.distributed.is_initialized() else None)
        steps, log_t0, log_steps = 0, time.time(), 0
        while steps < args.steps_per_round:
            for x1, extras in prefetch(device_batches()):
                state, metrics = train_step(state, teacher_params, x1, extras,
                                            step_seed(args.seed, step_total))
                steps, step_total, log_steps = steps + 1, step_total + 1, log_steps + 1
                if steps % args.log_step == 0:
                    dt = time.time() - log_t0
                    logger.info(f"round {rnd + 1} step {steps}/{args.steps_per_round}: "
                                f"loss {float(metrics['loss']):.5f} "
                                f"mse {float(metrics['mse']):.6f} "
                                f"grad_norm {float(metrics['grad_norm']):.4f} "
                                f"steps/sec {log_steps / dt:.3f}")
                    log_t0, log_steps = time.time(), 0
                if steps >= args.steps_per_round:
                    break
        # the round's student (its EMA weights, as sampled) is the next teacher
        teacher_params = {k: v.clone() for k, v in state.ema_params.items()}
        teacher_diff = student_diff
        cfg = dict(tcfg, distilled=True,
                   distill_tmap=[int(v) for v in student_diff.timestep_map.tolist()],
                   distill_round=rnd + 1, teacher_ckpt=teacher_src, model="diffusion",
                   latent_size=latent_size)
        if is_main:
            ckpt.save_config(cfg)
            ckpt.save(state, f"T{Ts}")
            ckpt.save(state, "last")
        logger.info(f"round {rnd + 1} done: saved {args.exp}/T{Ts} ({Ts}-step student)")
    logger.info("distillation done; evaluate with: python -m codlad_tpu_torch.cli.test "
                f"--latent_ckpt {args.exp} (the DDIM sampler and the student's grid come "
                "from its config)")
    return state


if __name__ == "__main__":
    main()
