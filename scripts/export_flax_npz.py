"""Export a trained Stage-1 VQ-VAE or Stage-2 denoiser (orbax checkpoint) to
one npz that the PyTorch port reads, plus a small fixture of frames with the
JAX package's outputs on them.

    JAX_PLATFORMS=cpu python scripts/export_flax_npz.py \
        [--ckpt results/convergence/vqvae] [--stats results/convergence/stats/CONV_stats.npz] \
        [--out weights/convergence_vqvae.npz] [--fixture weights/convergence_vqvae_fixture.npz]
    JAX_PLATFORMS=cpu python scripts/export_flax_npz.py --kind latent \
        [--ckpt results/convergence/latent] [--vae_ckpt results/convergence/vqvae] \
        [--out weights/convergence_latent.npz] [--fixture weights/convergence_latent_fixture.npz] \
        [--stats_copy weights/CONV_stats.npz]

Needs JAX, flax, optax and orbax (it reads the checkpoints as
codlad_tpu/cli/test.py `_load_vae` and its latent branch do); the port never
imports this file.

`--kind vqvae` (the default): the weights file holds `params/<flax path>`
leaves (f32), `codebook` [n_codes, vqdim] with its EMA statistics
`cluster_size` [n_codes] and `embed_avg` [n_codes, vqdim] (the rest of the
VQ state, for training from these weights), `config` (the checkpoint's
modelparams.json) and `stats_mean` / `stats_std`. The fixture holds the
first --frames frames of the convergence study's val protein prot_0030,
regenerated with the study's recipe (results/convergence/README.md:
`--synthetic 32 88 1000 --structured --res_range 48 128 --seed 0`), padded
as one batch (`batch/<key>`), and the JAX recon path on them in f32: the
pre-VQ latents, the VQ codes, ic, xyz14 and per-frame metrics
(`metric/<name>`, [frames]).

`--kind latent`: the weights file holds `params/<flax path>` and
`ema_params/<flax path>` (f32), `config` and `stats_mean` / `stats_std`; the
stats file is also copied to --stats_copy (the card gets no `results/`).
The fixture is computed in f32 on the VQ-VAE fixture's frames (its
`batch/*`, read from --vae_fixture, not stored again) with the EMA weights,
the JAX featurizer in its exact `idx` gather mode (at L <= 256 its default
gathers through a bf16 one-hot matmul, which rounds the C-alpha
coordinates; the port gathers by index): `x_T` (numpy, seed
--noise_seed), `cond_idx` (the kNN indices), `denoise_t` and `denoise_out`
(one denoise of x_T at base timestep `denoise_t`), `latents` (the
normalised latents of a 100-step DDIM run at eta 0 from x_T on
create_diffusion("100"), through SamplingPipeline._compute_condition /
_sample_from_cond), and on them the VQ `codes`, `xyz14` and per-frame
`metric/<name>`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np


def _flat(tree, prefix=("params",)):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def vq_state_arrays(vq_state):
    """The npz keys of a quantizer's state: `vq_state/<field>` for one
    VQState, `vq_state/<i>/<field>` for the lists of rvq and multihead, none
    for fsq (codlad_tpu_torch.convert.from_flax.read_flax_npz reads them
    back as its `vq_state` tree)."""
    if vq_state is None:
        return {}
    states = vq_state if isinstance(vq_state, (list, tuple)) else [vq_state]
    out = {}
    for i, st in enumerate(states):
        prefix = f"vq_state/{i}/" if isinstance(vq_state, (list, tuple)) else "vq_state/"
        for field in ("codebook", "cluster_size", "embed_avg"):
            out[prefix + field] = np.asarray(getattr(st, field), np.float32)
    return out


def val_frames(n_frames, index=30, seed=0, res_range=(48, 128)):
    """The first n_frames of synthetic protein `index` of the study's corpus
    (codlad_tpu/cli/preprocess.py --synthetic, --structured, --res_range)."""
    from codlad_tpu.data.synthetic import synthetic_examples

    lens_rng = np.random.default_rng(seed + 991)
    for _ in range(index + 1):
        n_res = int(lens_rng.integers(res_range[0], res_range[1] + 1))
    return synthetic_examples(n_frames, n_res, seed=seed + index, prot_idx=index,
                              structured=True)


def restore_vqvae(ckpt_dir, batch):
    """(flax VAE, TrainState with the VQ state, config) from a Stage-1
    checkpoint, as codlad_tpu/cli/test.py `_load_vae` restores it."""
    import jax
    import optax

    from codlad_tpu.models.vae import VAE
    from codlad_tpu.models.vq import build_quantize
    from codlad_tpu.train.checkpoints import CheckpointManager
    from codlad_tpu.train.state import create_train_state

    ckpt = CheckpointManager(ckpt_dir)
    cfg = ckpt.load_config()
    vae = VAE(mode=cfg.get("train_section", "vqvae"), embed_dim=cfg.get("embed_dim", 36),
              vqdim=cfg.get("vqdim", 3), predict_angle=cfg.get("predict_angle", False),
              n_rbf=cfg.get("n_rbf", 15), dec_cutoff=cfg.get("cg_cutoff", 21.0),
              dec_nconv=cfg.get("dec_nconv", 4), enc_nconv=cfg.get("enc_nconv", 3),
              atom_cutoff=cfg.get("atom_cutoff", 9.0), cg_cutoff=cfg.get("cg_cutoff", 21.0))
    rng = jax.random.PRNGKey(0)
    params = jax.jit(vae.init)(rng, batch)
    quantizer = build_quantize(cfg.get("quantize_type", "vqvae"),
                               codebook_size=cfg.get("codebook_size", 4096),
                               dim=cfg.get("vqdim", 3), levels=cfg.get("fsq_levels"),
                               n_stages=cfg.get("vq_stages", 2), n_heads=cfg.get("vq_heads"))
    state = create_train_state(params, optax.identity(), vq_state=quantizer.init(rng))
    state = ckpt.restore(state, "best" if ckpt.exists("best") else "last")
    return vae, state, cfg


def restore_latent(ckpt_dir, batch, latent_size=3):
    """(flax denoiser, TrainState with params and EMA, config) from a Stage-2
    checkpoint, as codlad_tpu/cli/test.py:216-235 restores it for
    evaluation (dropout 0)."""
    import jax
    import jax.numpy as jnp
    import optax

    from codlad_tpu.models.denoiser import MPNN_MODELS
    from codlad_tpu.train.checkpoints import CheckpointManager
    from codlad_tpu.train.state import create_train_state

    ckpt = CheckpointManager(ckpt_dir)
    cfg = ckpt.load_config()
    learn_sigma = cfg.get("model", "diffusion") in ("diffusion", "sbcfm")
    denoiser = MPNN_MODELS[cfg.get("backbone", "mpnn_diffusion")](
        input_size=latent_size, learn_sigma=learn_sigma, dropout=0.0,
        adaln_mode=cfg.get("adaln_mode", "trunk"),
        self_condition=cfg.get("self_condition", False))
    B, L = batch["res_type"].shape
    params = jax.jit(denoiser.init)(
        jax.random.PRNGKey(0), jnp.zeros((B, L, latent_size)), jnp.zeros((B,), jnp.int32),
        batch["res_type"], batch["cg_xyz_og"][:, 1:-1], batch["res_mask"])
    state = create_train_state(params, optax.identity(), with_ema=True)
    state = ckpt.restore(state, "best" if ckpt.exists("best") else "last")
    return denoiser, state, cfg


def idx_gather_patches():
    """[(module, attribute, replacement)] that make the JAX featurizer gather
    neighbours by index (`make_neighbor_gather(mode="idx")`), as the port
    does: at L <= 256 its 'auto' mode gathers through a bf16 one-hot matmul,
    which rounds the C-alpha coordinates. The one rule for the fixture here
    and for the parity tests (tests/_torch_parity.py `exact_gathers`)."""
    from codlad_tpu.models import denoiser
    from codlad_tpu.nn import mpnn

    orig = mpnn.make_neighbor_gather

    def idx_only(E_idx, mode="auto", dtype=None, n_nodes=None):
        return orig(E_idx, mode="idx", n_nodes=n_nodes)

    return [(m, "make_neighbor_gather", idx_only) for m in (mpnn, denoiser)]


@contextlib.contextmanager
def exact_gathers():
    """`idx_gather_patches` applied within the block."""
    patches = idx_gather_patches()
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    try:
        for m, name, fn in patches:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def per_frame_metrics(batch, ic, xyz14):
    """{`metric/<name>`: [frames]} of the JAX `evaluate_structures`."""
    from codlad_tpu.eval.harness import evaluate_structures

    n = batch["res_type"].shape[0]
    frames = [evaluate_structures({k: v[i:i + 1] for k, v in batch.items()},
                                  ic[i:i + 1], xyz14[i:i + 1]) for i in range(n)]
    return {f"metric/{k}": np.array([float(m[k]) for m in frames], np.float64)
            for k in frames[0]}


def export_vqvae(args):
    import jax.numpy as jnp

    from codlad_tpu.data.batch import collate, quantize_spec, spec_for
    from codlad_tpu.eval.harness import SamplingPipeline
    from codlad_tpu.models.vq import nearest_code

    examples = val_frames(args.frames)
    nb = collate(examples, quantize_spec(spec_for(examples)))
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    vae, state, cfg = restore_vqvae(args.ckpt, batch)
    stats = np.load(args.stats)
    mean, std = stats["mean"].astype(np.float32), stats["std"].astype(np.float32)
    codebook = np.asarray(state.vq_state.codebook, np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **dict(_flat(state.params["params"])), codebook=codebook,
                        cluster_size=np.asarray(state.vq_state.cluster_size, np.float32),
                        embed_avg=np.asarray(state.vq_state.embed_avg, np.float32),
                        **vq_state_arrays(state.vq_state),
                        config=np.array(json.dumps(cfg)), stats_mean=mean, stats_std=std)

    pipe = SamplingPipeline(denoiser=None, denoiser_params=None, process=None,
                            process_kind="diffusion", vae=vae, vae_params=state.params,
                            vq_state=state.vq_state, norm_mean=mean, norm_std=std,
                            latent_size=cfg.get("vqdim", 3))
    h = np.asarray(pipe.encode_latents(batch))
    ic, xyz14 = pipe.decode(batch, jnp.asarray((h - mean) / std))
    codes = np.asarray(nearest_code(jnp.asarray(codebook),
                                    jnp.asarray(h).reshape(-1, h.shape[-1]))).reshape(h.shape[:2])
    metrics = per_frame_metrics(batch, ic, xyz14)
    np.savez_compressed(args.fixture, **{f"batch/{k}": v for k, v in nb.items()},
                        latents=h.astype(np.float32), codes=codes.astype(np.int32),
                        ic=np.asarray(ic, np.float32), xyz14=np.asarray(xyz14, np.float32),
                        **metrics)
    return metrics


def latent_fixture(denoiser, params, vae, vae_state, mean, std, batch, noise_seed=0,
                   denoise_t=500, steps="100"):
    """The JAX package's f32 outputs of the denoiser `params` on `batch`
    (exact gathers): the fixture's arrays, as a dict."""
    import jax
    import jax.numpy as jnp

    from codlad_tpu.eval.harness import SamplingPipeline
    from codlad_tpu.gen.diffusion import create_diffusion
    from codlad_tpu.models.denoiser import MPNNDenoiser
    from codlad_tpu.models.vq import nearest_code

    B, L = batch["res_type"].shape
    C = denoiser.input_size
    x_T = np.random.default_rng(noise_seed).standard_normal((B, L, C)).astype(np.float32)
    pipe = SamplingPipeline(denoiser=denoiser, denoiser_params=params,
                            process=create_diffusion(steps, learn_sigma=True),
                            process_kind="diffusion", vae=vae, vae_params=vae_state.params,
                            vq_state=vae_state.vq_state, norm_mean=mean, norm_std=std,
                            latent_size=C, sampler="ddim", ddim_eta=0.0)
    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    with exact_gathers():
        cond = pipe._compute_condition(params, extras)
        out = jax.jit(lambda p, x, c: denoiser.apply(
            p, x, jnp.full((B,), denoise_t, jnp.int32), c, deterministic=True,
            fuse_pairs=False, method=MPNNDenoiser.denoise))(params, jnp.asarray(x_T), cond)
        lat = pipe._sample_from_cond(jax.random.PRNGKey(0), params, cond, jnp.asarray(x_T))
    ic, xyz14 = pipe.decode(batch, lat)
    z = np.asarray(lat) * std + mean
    codebook = jnp.asarray(vae_state.vq_state.codebook)
    codes = np.asarray(nearest_code(codebook, jnp.asarray(z).reshape(-1, C))).reshape(B, L)
    return {"x_T": x_T, "cond_idx": np.asarray(cond["nbr"]["idx"], np.int32),
            "denoise_t": np.int32(denoise_t), "denoise_out": np.asarray(out, np.float32),
            "latents": np.asarray(lat, np.float32), "codes": codes.astype(np.int32),
            "xyz14": np.asarray(xyz14, np.float32), **per_frame_metrics(batch, ic, xyz14)}


def write_latent_weights(path, state, cfg, mean, std):
    """The Stage-2 weights file: `params/...` and `ema_params/...` leaves
    (f32), `config` (JSON) and the latent stats."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **dict(_flat(state.params["params"])),
                        **dict(_flat(state.ema_params["params"], ("ema_params",))),
                        config=np.array(json.dumps(cfg)), stats_mean=mean, stats_std=std)


def export_latent(args):
    import shutil

    import jax.numpy as jnp

    with np.load(args.vae_fixture) as fx:
        batch = {k[len("batch/"):]: jnp.asarray(fx[k]) for k in fx.files
                 if k.startswith("batch/")}
    vae, vae_state, _ = restore_vqvae(args.vae_ckpt, batch)
    denoiser, state, cfg = restore_latent(args.ckpt, batch)
    stats = np.load(args.stats)
    mean, std = stats["mean"].astype(np.float32), stats["std"].astype(np.float32)

    write_latent_weights(args.out, state, cfg, mean, std)
    if args.stats_copy:
        shutil.copyfile(args.stats, args.stats_copy)
    fx = latent_fixture(denoiser, state.ema_params, vae, vae_state, mean, std, batch,
                        noise_seed=args.noise_seed)
    np.savez_compressed(args.fixture, **fx)
    return {k: v for k, v in fx.items() if k.startswith("metric/")}


DEFAULTS = {"vqvae": ("results/convergence/vqvae", "weights/convergence_vqvae.npz",
                      "weights/convergence_vqvae_fixture.npz"),
            "latent": ("results/convergence/latent", "weights/convergence_latent.npz",
                       "weights/convergence_latent_fixture.npz")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", default="vqvae", choices=sorted(DEFAULTS))
    ap.add_argument("--ckpt", default=None, help="default: the study's checkpoint of --kind")
    ap.add_argument("--stats", default="results/convergence/stats/CONV_stats.npz")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fixture", default=None)
    ap.add_argument("--frames", type=int, default=4, help="vqvae: frames of the fixture")
    ap.add_argument("--vae_ckpt", default="results/convergence/vqvae",
                    help="latent: the VQ-VAE that decodes the fixture's latents")
    ap.add_argument("--vae_fixture", default="weights/convergence_vqvae_fixture.npz",
                    help="latent: the fixture whose batch/* frames are reused")
    ap.add_argument("--stats_copy", default="weights/CONV_stats.npz",
                    help="latent: where to copy --stats ('' to skip)")
    ap.add_argument("--noise_seed", type=int, default=0, help="latent: seed of x_T")
    args = ap.parse_args(argv)
    ckpt, out, fixture = DEFAULTS[args.kind]
    args.ckpt, args.out, args.fixture = args.ckpt or ckpt, args.out or out, args.fixture or fixture

    metrics = (export_latent if args.kind == "latent" else export_vqvae)(args)
    for path in (args.out, args.fixture):
        print(f"{path}: {os.path.getsize(path)} bytes")
    print("per-frame rmsd_aligned:", metrics["metric/rmsd_aligned"])


if __name__ == "__main__":
    main()
