"""`python -m codlad_tpu_torch.cli.test --experiment recon --device cpu` on a
tiny shard directory written by the JAX package, with a weights file in the
layout scripts/export_flax_npz.py writes (random flax params of a small
VQ-VAE): summary_stats.json per protein and global, and each protein's
metrics against the JAX recon path on the same frames (rtol 1e-4: f32 sums
in another order). Without a card, --device cuda exits non-zero."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import random_params
from codlad_tpu.data.shards import load_protein_shard, save_protein_shard
from codlad_tpu.data.synthetic import synthetic_examples
from codlad_tpu.eval.harness import SamplingPipeline as JaxPipeline
from codlad_tpu.eval.harness import evaluate_structures
from codlad_tpu.models.vae import VAE as JaxVAE
from codlad_tpu.models.vq import VQState
from codlad_tpu_torch.cli import test as CLI

CFG = {"train_section": "vqvae", "embed_dim": 8, "vqdim": 3, "enc_nconv": 2,
       "dec_nconv": 2, "n_rbf": 15, "atom_cutoff": 9.0, "cg_cutoff": 21.0,
       "codebook_size": 32}


def _flat(tree, prefix=("params",)):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


@pytest.fixture
def workdir(tmp_path):
    shards = tmp_path / "shards"
    shards.mkdir()
    for i, n_res in enumerate((20, 27)):
        save_protein_shard(str(shards / f"prot_{i:04d}.npz"),
                           synthetic_examples(2, n_res, seed=i, prot_idx=i))
    _, data = load_protein_shard(str(shards / "prot_0000.npz"))
    vae = JaxVAE(embed_dim=8, vqdim=3, enc_nconv=2, dec_nconv=2)
    params = random_params(vae, 7, {k: jnp.asarray(v) for k, v in data.items()})
    codebook = np.random.default_rng(8).normal(size=(32, 3)).astype(np.float32)
    np.savez(tmp_path / "w.npz", **dict(_flat(params["params"])), codebook=codebook,
             config=np.array(json.dumps(CFG)))
    return tmp_path, vae, params, codebook


def test_recon_cli_matches_jax(workdir):
    tmp, vae, params, codebook = workdir
    summary = CLI.main(["--experiment", "recon", "--vae_weights", str(tmp / "w.npz"),
                        "--data_dir", str(tmp / "shards"), "--out_dir", str(tmp / "eval"),
                        "--device", "cpu"])
    with open(tmp / "eval" / "summary_stats.json") as f:
        assert json.load(f) == summary
    assert set(summary) == {"prot_0000.npz", "prot_0001.npz", "__global__",
                            "__global_stats__"}
    pipe = JaxPipeline(denoiser=None, denoiser_params=None, process=None,
                       process_kind="diffusion", vae=vae, vae_params=params,
                       vq_state=VQState(codebook=jnp.asarray(codebook),
                                        cluster_size=jnp.zeros(32),
                                        embed_avg=jnp.asarray(codebook)),
                       norm_mean=np.zeros(3, np.float32), norm_std=np.ones(3, np.float32))
    for name in ("prot_0000.npz", "prot_0001.npz"):
        _, data = load_protein_shard(os.path.join(tmp, "shards", name))
        batch = {k: jnp.asarray(v) for k, v in data.items()}
        ic, xyz = pipe.decode(batch, pipe.encode_latents(batch))
        want = evaluate_structures(batch, ic, xyz)
        for k in ("rmsd", "rmsd_aligned", "ged", "clash", "bond", "angle", "torsion"):
            np.testing.assert_allclose(summary[name][k], float(want[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} {k}")
    means = [summary[n]["rmsd_aligned"] for n in ("prot_0000.npz", "prot_0001.npz")]
    np.testing.assert_allclose(summary["__global__"]["rmsd_aligned"], np.mean(means))


def test_recon_cli_needs_a_card_for_cuda(workdir):
    tmp = workdir[0]
    with pytest.raises(SystemExit) as exc:
        CLI.main(["--vae_weights", str(tmp / "w.npz"), "--data_dir", str(tmp / "shards"),
                  "--out_dir", str(tmp / "eval"), "--device", "cuda"])
    assert exc.value.code != 0
