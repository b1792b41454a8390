"""Export a trained Stage-1 VQ-VAE (orbax checkpoint) to one npz that the
PyTorch port reads, plus a small fixture of frames with the JAX package's
recon outputs on them.

    JAX_PLATFORMS=cpu python scripts/export_flax_npz.py \
        [--ckpt results/convergence/vqvae] [--stats results/convergence/stats/CONV_stats.npz] \
        [--out weights/convergence_vqvae.npz] [--fixture weights/convergence_vqvae_fixture.npz]

Needs JAX, flax, optax and orbax (it reads the checkpoint as
codlad_tpu/cli/test.py `_load_vae` does); the port never imports this file.

The weights file holds `params/<flax path>` leaves (f32), `codebook`
[n_codes, vqdim], `config` (the checkpoint's modelparams.json) and
`stats_mean` / `stats_std`. The fixture holds the first --frames frames of
the convergence study's val protein prot_0030, regenerated with the study's
recipe (results/convergence/README.md: `--synthetic 32 88 1000 --structured
--res_range 48 128 --seed 0`), padded as one batch (`batch/<key>`), and the
JAX recon path on them in f32: the pre-VQ latents, the VQ codes, ic, xyz14
and per-frame metrics (`metric/<name>`, [frames]).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _flat(tree, prefix=("params",)):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def val_frames(n_frames, index=30, seed=0, res_range=(48, 128)):
    """The first n_frames of synthetic protein `index` of the study's corpus
    (codlad_tpu/cli/preprocess.py --synthetic, --structured, --res_range)."""
    from codlad_tpu.data.synthetic import synthetic_examples

    lens_rng = np.random.default_rng(seed + 991)
    for _ in range(index + 1):
        n_res = int(lens_rng.integers(res_range[0], res_range[1] + 1))
    return synthetic_examples(n_frames, n_res, seed=seed + index, prot_idx=index,
                              structured=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default="results/convergence/vqvae")
    ap.add_argument("--stats", default="results/convergence/stats/CONV_stats.npz")
    ap.add_argument("--out", default="weights/convergence_vqvae.npz")
    ap.add_argument("--fixture", default="weights/convergence_vqvae_fixture.npz")
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import optax

    from codlad_tpu.data.batch import collate, quantize_spec, spec_for
    from codlad_tpu.eval.harness import SamplingPipeline, evaluate_structures
    from codlad_tpu.models.vae import VAE
    from codlad_tpu.models.vq import build_quantize, nearest_code
    from codlad_tpu.train.checkpoints import CheckpointManager
    from codlad_tpu.train.state import create_train_state

    examples = val_frames(args.frames)
    nb = collate(examples, quantize_spec(spec_for(examples)))
    batch = {k: jnp.asarray(v) for k, v in nb.items()}

    ckpt = CheckpointManager(args.ckpt)
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
    stats = np.load(args.stats)
    mean, std = stats["mean"].astype(np.float32), stats["std"].astype(np.float32)
    codebook = np.asarray(state.vq_state.codebook, np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **dict(_flat(state.params["params"])), codebook=codebook,
                        config=np.array(json.dumps(cfg)), stats_mean=mean, stats_std=std)

    pipe = SamplingPipeline(denoiser=None, denoiser_params=None, process=None,
                            process_kind="diffusion", vae=vae, vae_params=state.params,
                            vq_state=state.vq_state, norm_mean=mean, norm_std=std,
                            latent_size=cfg.get("vqdim", 3))
    h = np.asarray(pipe.encode_latents(batch))
    ic, xyz14 = pipe.decode(batch, jnp.asarray((h - mean) / std))
    codes = np.asarray(nearest_code(jnp.asarray(codebook),
                                    jnp.asarray(h).reshape(-1, h.shape[-1]))).reshape(h.shape[:2])
    per_frame = [evaluate_structures({k: v[i:i + 1] for k, v in batch.items()},
                                     ic[i:i + 1], xyz14[i:i + 1])
                 for i in range(args.frames)]
    metrics = {f"metric/{k}": np.array([float(m[k]) for m in per_frame], np.float64)
               for k in per_frame[0]}
    np.savez_compressed(args.fixture, **{f"batch/{k}": v for k, v in nb.items()},
                        latents=h.astype(np.float32), codes=codes.astype(np.int32),
                        ic=np.asarray(ic, np.float32), xyz14=np.asarray(xyz14, np.float32),
                        **metrics)
    for path in (args.out, args.fixture):
        print(f"{path}: {os.path.getsize(path)} bytes")
    print("per-frame rmsd_aligned:", metrics["metric/rmsd_aligned"])


if __name__ == "__main__":
    main()
