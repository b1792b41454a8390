"""Stage-1 recon on the CPU: the port's E3Encoder / VAE.encode and the whole
recon path (encode -> snap -> decode -> xyz14 -> metrics) against the JAX
package on the same featurized frames (JAX's synthetic generator, fed to
both) and the same converted random weights; the converted trained VQ-VAE
against the JAX outputs stored with it.

The JAX side runs its CPU path (DenseEdgeOps and `ref_fused_tp`).
Tolerances: f32 latents atol 1e-4 (sums in another order); the bf16
feature path atol 1e-2 (features rounded to 8 bits through three layers;
the readout is f32); VQ codes equal except where the JAX latent's two
nearest codes are within 1e-4 (squared distance) of a tie; ic and xyz14 of
the decode atol 1e-4; metrics rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_apply, random_params, t
from codlad_tpu.data.batch import collate, quantize_spec, spec_for
from codlad_tpu.data.synthetic import synthetic_examples
from codlad_tpu.eval.harness import SamplingPipeline as JaxPipeline
from codlad_tpu.eval.harness import evaluate_structures as jax_evaluate
from codlad_tpu.models.vae import VAE as JaxVAE
from codlad_tpu.models.vq import VQState, nearest_code
from codlad_tpu_torch.convert.from_flax import load_flax
from codlad_tpu_torch.eval.harness import SamplingPipeline, evaluate_structures
from codlad_tpu_torch.models.vae import VAE

WEIGHTS = "weights/convergence_vqvae.npz"
FIXTURE = "weights/convergence_vqvae_fixture.npz"


def _batch(seed=0, n_frames=2, n_res=26):
    ex = synthetic_examples(n_frames, n_res, seed=seed)
    return collate(ex, quantize_spec(spec_for(ex)))


def _pair(nb, seed, compute_dtype="float32"):
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    vae = JaxVAE(embed_dim=36, vqdim=3, compute_dtype=compute_dtype)
    params = random_params(vae, seed, jb)
    port = load_flax(VAE(torch.Generator().manual_seed(0),
                         compute_dtype=getattr(torch, compute_dtype)), params)
    return vae, params, port.eval(), jb


def _gaps(codebook, z):
    d = ((z.reshape(-1, 1, z.shape[-1]) - codebook[None]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[:, :2]
    return (two[:, 1] - two[:, 0]).reshape(z.shape[:-1])


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_encoder_matches_jax(dtype, atol):
    nb = _batch()
    vae, params, port, jb = _pair(nb, 3, dtype)
    want = np.asarray(jax_apply(vae, params, jb, method=JaxVAE.encode)[0])
    with torch.no_grad():
        got = port.encode({k: t(v) for k, v in nb.items()})
    assert got.shape == want.shape == nb["res_type"].shape + (3,)
    assert got.dtype == torch.float32 and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_recon_path_matches_jax():
    nb = _batch(seed=4, n_frames=2, n_res=30)
    vae, params, port, jb = _pair(nb, 5)
    rng = np.random.default_rng(6)
    codebook = rng.normal(size=(64, 3)).astype(np.float32)
    mean = np.array([0.1, -0.2, 0.05], np.float32)
    std = np.array([1.5, 0.7, 1.1], np.float32)
    jpipe = JaxPipeline(denoiser=None, denoiser_params=None, process=None,
                        process_kind="diffusion", vae=vae, vae_params=params,
                        vq_state=VQState(codebook=jnp.asarray(codebook),
                                         cluster_size=jnp.zeros(64),
                                         embed_avg=jnp.asarray(codebook)),
                        norm_mean=mean, norm_std=std)
    h_want = np.asarray(jpipe.encode_latents(jb))
    ic_want, xyz_want = jpipe.decode(jb, jnp.asarray((h_want - mean) / std))
    m_want = {k: float(v) for k, v in jax_evaluate(jb, ic_want, xyz_want).items()}
    codes_want = np.asarray(nearest_code(jnp.asarray(codebook), jnp.asarray(h_want)
                                         .reshape(-1, 3))).reshape(h_want.shape[:2])

    pipe = SamplingPipeline(denoiser=None, process=None, vae=port,
                            codebook=torch.from_numpy(codebook), norm_mean=mean, norm_std=std)
    batch = {k: t(v) for k, v in nb.items()}
    h = pipe.encode_latents(batch)
    ic, xyz, codes = pipe.decode(batch, pipe.normalise(h), return_codes=True)
    m = {k: float(v) for k, v in evaluate_structures(batch, ic, xyz).items()}
    np.testing.assert_allclose(h.numpy(), h_want, atol=1e-4)
    valid = nb["res_mask"] & (_gaps(codebook, h_want) > 1e-4)
    assert valid.sum() > 0.9 * nb["res_mask"].sum()
    np.testing.assert_array_equal(codes.numpy()[valid], codes_want[valid])
    np.testing.assert_allclose(ic.numpy(), np.asarray(ic_want), atol=1e-4)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_want), atol=1e-4)
    assert m.keys() == m_want.keys()
    for k in m:
        np.testing.assert_allclose(m[k], m_want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_trained_vqvae_matches_jax_fixture():
    """The converted study checkpoint (scripts/export_flax_npz.py) on its
    fixture frames: the JAX outputs stored there at f32 tolerance."""
    from codlad_tpu_torch.cli.test import load_vae_weights
    from codlad_tpu_torch.convert.from_flax import read_flax_npz
    vae, snap, cfg = load_vae_weights(WEIGHTS, "cpu")
    codebook = snap["vq_state"].codebook
    assert (cfg["embed_dim"], cfg["vqdim"], cfg["codebook_size"]) == (36, 3, 512)
    mean, std = read_flax_npz(WEIGHTS)["stats"]
    with np.load(FIXTURE) as fx:
        want = {k: fx[k] for k in fx.files}
    batch = {k[6:]: torch.as_tensor(v) for k, v in want.items() if k.startswith("batch/")}
    pipe = SamplingPipeline(denoiser=None, process=None, vae=vae, codebook=codebook,
                            norm_mean=mean, norm_std=std)
    h = pipe.encode_latents(batch)
    ic, xyz, codes = pipe.decode(batch, pipe.normalise(h), return_codes=True)
    np.testing.assert_allclose(h.numpy(), want["latents"], atol=1e-4)
    valid = batch["res_mask"].numpy() & (_gaps(codebook.numpy(), want["latents"]) > 1e-4)
    np.testing.assert_array_equal(codes.numpy()[valid], want["codes"][valid])
    np.testing.assert_allclose(ic.numpy(), want["ic"], atol=1e-4)
    np.testing.assert_allclose(xyz.numpy(), want["xyz14"], atol=1e-4)
    frames = evaluate_structures(batch, ic, xyz, per_frame=True)
    np.testing.assert_allclose(frames["rmsd_aligned"].numpy(), want["metric/rmsd_aligned"],
                               atol=1e-4)
