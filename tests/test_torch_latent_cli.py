"""The trained Stage-2 denoiser and `cli.test --experiment latent` / `prior`
in the port, against the JAX package, on the CPU in f32.

The study's trained denoiser (results/convergence/latent, converted by
scripts/export_flax_npz.py --kind latent into weights/convergence_latent.npz,
params and EMA) runs in both packages on two of the four prot_0030 frames
of weights/convergence_vqvae_fixture.npz, with the JAX featurizer in its
exact gather mode (tests/_torch_parity.py `exact_gathers`). Tolerances:
- the kNN indices equal as sets per row (near-equal distances to residues
  i - 1 and i + 1 may come in either order; the decoder sums over all K);
- h_E0 within atol 2e-3 (ROADMAP: the self-edge quaternion of a
  near-identity rotation turns f32 rounding into ~3e-4), h_S exact;
- one denoise within atol 2e-5 (outputs up to ~2; sums in another order);
- a 10-step DDIM at eta 0 and 5 ancestral steps with JAX's noise replayed:
  latents within 1e-5 of max|latent| (the early steps scale x by
  sqrt(1/acp) ~ 70 at t 900, so the latents reach hundreds).
`run_ensemble` and `diversity` are held against JAX's on the same injected
structures (rtol 1e-5: f32 SVDs in another library). The CLI runs `latent`
and `prior` on a tiny shard directory with the trained weights, and with a
`--latent_ckpt` of the port's own trainer; its summary has the keys of the
study's JAX summaries (results/convergence/eval_{latent,prior}).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import exact_gathers, export_script, replay_ancestral_noises, t
from codlad_tpu.eval.harness import run_ensemble as jax_run_ensemble
from codlad_tpu.eval.metrics import diversity as jax_diversity
from codlad_tpu.gen import diffusion as JD
from codlad_tpu.models import denoiser as JDEN
from codlad_tpu.train.checkpoints import CheckpointManager as JaxCheckpoints
from codlad_tpu.train.state import create_train_state
from codlad_tpu_torch.cli import test as CLI
from codlad_tpu_torch.convert.from_flax import (denoiser_from_config, flax_to_state_dict,
                                                load_denoiser, read_flax_npz)
from codlad_tpu_torch.data.batch import collate, quantize_spec, spec_for
from codlad_tpu_torch.data.cg_batch import write_synthetic_features
from codlad_tpu_torch.data.shards import save_protein_shard
from codlad_tpu_torch.data.synthetic import corpus_protein, synthetic_examples
from codlad_tpu_torch.eval import harness as TH
from codlad_tpu_torch.eval.metrics import diversity
from codlad_tpu_torch.gen import diffusion as TD
from codlad_tpu_torch.models.denoiser import MPNNDenoiser


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the suite runs this file beside its other
    workers on the same cores, where torch's thread pools oversubscribe
    them; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "convergence_latent.npz")
VAE_WEIGHTS = os.path.join(REPO, "weights", "convergence_vqvae.npz")
VAE_FIXTURE = os.path.join(REPO, "weights", "convergence_vqvae_fixture.npz")
CKPT = os.path.join(REPO, "results", "convergence", "latent")
FRAMES = 2


def _fixture_batch(n=FRAMES):
    with np.load(VAE_FIXTURE) as fx:
        return {k[len("batch/"):]: fx[k][:n] for k in fx.files if k.startswith("batch/")}


def _extras(nb, to):
    return {"res_type": to(nb["res_type"]), "cg_xyz": to(nb["cg_xyz_og"][:, 1:-1]),
            "mask": to(nb["res_mask"])}


def _jax_tree(tree):
    return {"params": jax.tree.map(jnp.asarray, tree)}


@pytest.fixture(scope="module")
def trained():
    """The JAX model, the converted weights, 2 fixture frames, x_T and the
    jitted JAX conditioning and denoise (weights passed as arguments)."""
    w = read_flax_npz(WEIGHTS)
    model = JDEN.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0)
    nb = _fixture_batch()
    x_T = np.random.default_rng(11).standard_normal(nb["res_type"].shape + (3,)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        exact_gathers(mp)
        cond_fn = jax.jit(lambda p, e: model.apply(p, e["res_type"], e["cg_xyz"], e["mask"],
                                                   method=JDEN.MPNNDenoiser.compute_condition))
        conds = {k: cond_fn(_jax_tree(w[k]), _extras(nb, jnp.asarray))
                 for k in ("params", "ema_params")}
    den_fn = jax.jit(lambda p, x, tb, c: model.apply(p, x, tb, c, deterministic=True,
                                                     fuse_pairs=False,
                                                     method=JDEN.MPNNDenoiser.denoise))
    return {"w": w, "nb": nb, "x_T": x_T, "conds": conds, "den_fn": den_fn}


def _port(kind):
    return load_denoiser(WEIGHTS, "cpu", use_ema=kind == "ema_params")[0]


def _close_to_scale(got, want, rel, what):
    scale = float(np.abs(want).max())
    d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert d <= rel * scale, f"{what}: max|d| {d:.3g} > {rel:g} x max|ref| {scale:.3g}"


@pytest.mark.parametrize("kind", ["params", "ema_params"])
def test_trained_denoiser_matches_jax(trained, kind):
    """compute_condition, one denoise at t 500 and a 10-step DDIM at eta 0
    of the converted weights against the JAX package on the same weights."""
    w, nb, x_T = trained["w"], trained["nb"], trained["x_T"]
    jp, jcond = _jax_tree(w[kind]), trained["conds"][kind]
    port = _port(kind)
    with torch.no_grad():
        cond = port.compute_condition(*_extras(nb, t).values())
    # rows in neighbour-index order: equal sets, edge features matched by index
    order = [np.argsort(i, -1, kind="stable")
             for i in (cond["idx"].numpy(), np.asarray(jcond["nbr"]["idx"]))]
    by_idx = lambda a, o: np.take_along_axis(a, o if a.ndim == 3 else o[..., None], 2)
    np.testing.assert_array_equal(by_idx(cond["idx"].numpy(), order[0]),
                                  by_idx(np.asarray(jcond["nbr"]["idx"]), order[1]))
    np.testing.assert_allclose(by_idx(cond["h_E0"].numpy(), order[0]),
                               by_idx(np.asarray(jcond["h_E0"]), order[1]), atol=2e-3)
    np.testing.assert_array_equal(cond["h_S"].numpy(), np.asarray(jcond["h_S"]))
    np.testing.assert_allclose(cond["mask_attend"].numpy(), np.asarray(jcond["mask_attend"]))

    tb = np.full((FRAMES,), 500, np.int32)
    want = trained["den_fn"](jp, jnp.asarray(x_T), jnp.asarray(tb), jcond)
    with torch.no_grad():
        got = port.denoise(t(x_T), t(tb).long(), cond)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    jd = JD.create_diffusion("10", learn_sigma=True)
    model_fn = lambda x, tb, k: trained["den_fn"](jp, x, tb, jcond)
    want = jd.ddim_sample_loop(jax.random.PRNGKey(0), model_fn, x_T.shape,
                               noise=jnp.asarray(x_T), eta=0.0)
    pipe = TH.SamplingPipeline(denoiser=port, process=TD.create_diffusion("10"), vae=None,
                               codebook=None, norm_mean=np.zeros(3), norm_std=np.ones(3),
                               sampler="ddim")
    got = pipe.sample_latents(_extras(nb, t), noise=t(x_T))
    _close_to_scale(got.numpy(), np.asarray(want), 1e-5, "10-step DDIM latents")


def test_trained_ancestral_steps_match_jax(trained):
    """Five ancestral steps (respacing "5") of the EMA weights with JAX's
    per-step noise replayed."""
    w, nb, x_T = trained["w"], trained["nb"], trained["x_T"]
    jp, jcond = _jax_tree(w["ema_params"]), trained["conds"]["ema_params"]
    jd = JD.create_diffusion("5", learn_sigma=True)
    rng = jax.random.PRNGKey(5)
    model_fn = lambda x, tb, k: trained["den_fn"](jp, x, tb, jcond)
    want = jd.p_sample_loop(rng, model_fn, x_T.shape, noise=jnp.asarray(x_T))
    zs = [t(z) for z in replay_ancestral_noises(rng, jd.num_timesteps, x_T.shape)]
    pipe = TH.SamplingPipeline(denoiser=_port("ema_params"), process=TD.create_diffusion("5"),
                               vae=None, codebook=None, norm_mean=np.zeros(3),
                               norm_std=np.ones(3))
    got = pipe.sample_latents(_extras(nb, t), noise=t(x_T), noises=zs)
    _close_to_scale(got.numpy(), np.asarray(want), 1e-5, "5 ancestral steps")


def _random_state(model, nb, seed):
    """A flax TrainState of `model` with params and an EMA that differ."""
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros(nb["res_type"].shape + (3,)), jnp.zeros((nb["res_type"].shape[0],),
                                                             jnp.int32),
        jnp.asarray(nb["res_type"]), jnp.asarray(nb["cg_xyz_og"][:, 1:-1]),
        jnp.asarray(nb["res_mask"])), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    draw = lambda s: jnp.asarray(0.05 * rng.normal(size=s.shape), jnp.float32)
    params = jax.tree.map(draw, shapes)
    state = create_train_state(params, optax.identity(), with_ema=True)
    return state.replace(ema_params=jax.tree.map(draw, shapes))


def test_export_round_trip_through_an_orbax_checkpoint(tmp_path):
    """A Stage-2 checkpoint written by the JAX package's CheckpointManager
    goes through export_flax_npz's restore and writer into the port, params
    and EMA each to their own tree, unchanged."""
    exp = export_script()
    nb = _fixture_batch()
    cfg = {"model": "diffusion", "backbone": "mpnn_diffusion", "adaln_mode": "trunk",
           "self_condition": False, "diffusion_steps": 1000}
    state = _random_state(JDEN.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0),
                          nb, 3)
    ckpt = JaxCheckpoints(str(tmp_path / "latent"))
    ckpt.save_config(cfg)
    ckpt.save(state, "best")
    _, restored, rcfg = exp.restore_latent(str(tmp_path / "latent"),
                                           {k: jnp.asarray(v) for k, v in nb.items()})
    assert rcfg == cfg
    out = str(tmp_path / "latent.npz")
    exp.write_latent_weights(out, restored, rcfg, np.zeros(3, np.float32),
                             np.ones(3, np.float32))
    for kind, tree in (("params", state.params), ("ema_params", state.ema_params)):
        model, got_cfg, stats = load_denoiser(out, "cpu", use_ema=kind == "ema_params")
        assert got_cfg == cfg and stats is not None
        want = flax_to_state_dict(jax.device_get(tree))
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_export_holds_the_study_checkpoint():
    """weights/convergence_latent.npz holds results/convergence/latent/best
    as export_flax_npz restores it, params and EMA, bit for bit. The orbax
    checkpoint is in the repository but is left out of copies built from
    .gitignore; there the test has nothing to compare."""
    if not os.path.isdir(os.path.join(CKPT, "best")):
        pytest.skip(f"{CKPT}/best is not in this copy of the repository")
    nb = {k: jnp.asarray(v) for k, v in _fixture_batch().items()}
    _, state, cfg = export_script().restore_latent(CKPT, nb)
    w = read_flax_npz(WEIGHTS)
    assert w["config"] == cfg
    for kind, tree in (("params", state.params), ("ema_params", state.ema_params)):
        want = flax_to_state_dict(jax.device_get(tree))
        got = flax_to_state_dict(w[kind])
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{kind} {k}")


def test_corpus_protein_is_the_fixture_recipe():
    """The port's copy of the study's val-corpus recipe gives the frames the
    JAX package stored in the VQ-VAE fixture (prot_0030, first 4)."""
    ex = corpus_protein(30, 4)
    nb = collate(ex, quantize_spec(spec_for(ex)))
    want = _fixture_batch(4)
    assert set(nb) == set(want)
    for k in want:
        np.testing.assert_array_equal(nb[k], want[k], err_msg=k)


def _structures(nb, n, seed):
    """n structures [B, L, 14, 3] (the reference plus noise) and ic."""
    rng = np.random.default_rng(seed)
    xyz = nb["xyz14"][None] + rng.normal(0, 0.5, (n,) + nb["xyz14"].shape).astype(np.float32)
    ic = nb["ic"][None] + rng.normal(0, 0.1, (n,) + nb["ic"].shape).astype(np.float32)
    return ic, xyz


@pytest.mark.parametrize("fold", [1, 3])
def test_run_ensemble_matches_jax(fold):
    """The same injected structures (a sample_fn that hands out fixed arrays
    in order) give the same per-member metrics, means and DIV."""
    nb = _fixture_batch()
    n = 4
    ic, xyz = _structures(nb, n, 0)

    def feeder(wrap):
        pos = [0]

        def sample_fn(_, b):
            f = b["res_type"].shape[0] // FRAMES
            s = pos[0]
            pos[0] += f
            cat = lambda a: np.concatenate(list(a[s:s + f]), 0)
            return wrap(cat(ic)), wrap(cat(xyz))
        return sample_fn

    want = jax_run_ensemble(None, {k: jnp.asarray(v) for k, v in nb.items()}, n, seed=3,
                            sample_fn=feeder(jnp.asarray), fold=fold)
    got = TH.run_ensemble(None, {k: t(v) for k, v in nb.items()}, n, seed=3,
                          sample_fn=feeder(t), fold=fold)
    assert got.keys() == want.keys()
    assert len(got["per_ensemble"]) == n
    for gm, wm in zip(got["per_ensemble"], want["per_ensemble"]):
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want.items():
        if k != "per_ensemble":
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_diversity_matches_jax():
    rng = np.random.default_rng(4)
    gen = rng.normal(size=(5, 2, 40, 3)).astype(np.float32)
    ref = rng.normal(size=(2, 40, 3)).astype(np.float32)
    mask = rng.random((2, 40)) > 0.2
    want = jax_diversity(jnp.asarray(gen), jnp.asarray(ref), jnp.asarray(mask))
    got = diversity(t(gen), t(ref), t(mask))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(float(g), float(w_), rtol=1e-5)


@pytest.mark.parametrize("sampler,eta", [("ancestral", 0.0), ("ddim", 0.0), ("ddim", 0.5)])
def test_doubled_batch_returns_the_undoubled_samples(sampler, eta):
    gen = torch.Generator().manual_seed(0)
    model = MPNNDenoiser(gen, hidden_dim=32, edge_features=32, num_encoder_layers=2,
                         num_decoder_layers=1, k_neighbors=8, dropout=0.0).eval()
    nb = _fixture_batch()
    out = {}
    for doubled in (False, True):
        pipe = TH.SamplingPipeline(denoiser=model, process=TD.create_diffusion("ddim5"),
                                   vae=None, codebook=None, norm_mean=np.zeros(3),
                                   norm_std=np.ones(3), sampler=sampler, ddim_eta=eta,
                                   doubled_batch=doubled)
        out[doubled] = pipe.sample_latents(_extras(nb, t),
                                           generator=torch.Generator().manual_seed(1))
    assert out[True].shape == out[False].shape
    torch.testing.assert_close(out[True], out[False], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """Two proteins of 2 frames each, written by the port. (The study's JAX
    shards went through align_shard_buckets, which changes only the padded
    edge capacities, all masked: shards from save_protein_shard score the
    same.)"""
    d = tmp_path_factory.mktemp("shards")
    for i, n_res in enumerate((20, 27)):
        save_protein_shard(str(d / f"prot_{i:04d}.npz"),
                           synthetic_examples(2, n_res, seed=i, prot_idx=i, structured=True))
    return d


def _study_keys(experiment):
    with open(os.path.join(REPO, "results", "convergence", f"eval_{experiment}",
                           "summary_stats.json")) as f:
        s = json.load(f)
    proteins = [k for k in s if not k.startswith("__")]
    return (set(s[proteins[0]]), set(s[proteins[0]]["per_ensemble"][0]),
            set(s["__global__"]), set(s["__global_stats__"]))


def _keys(summary):
    proteins = [k for k in summary if not k.startswith("__")]
    assert len(proteins) == 2
    for p in proteins:
        assert len(summary[p]["per_ensemble"]) == 2
        assert all(np.isfinite(v) for v in summary[p].values() if np.isscalar(v))
    return (set(summary[proteins[0]]), set(summary[proteins[0]]["per_ensemble"][0]),
            set(summary["__global__"]), set(summary["__global_stats__"]))


CLI_ARGS = ["--vae_weights", VAE_WEIGHTS, "--stats_name", "CONV",
            "--stats_dir", os.path.join(REPO, "weights"), "--num_sampling_steps", "5",
            "--num_ensemble", "2", "--device", "cpu"]


@pytest.mark.parametrize("experiment", ["latent", "prior"])
def test_cli_runs_with_the_study_summary_keys(shard_dir, tmp_path, experiment):
    out = tmp_path / "eval"
    summary = CLI.main(["--experiment", experiment, "--latent_weights", WEIGHTS,
                        "--data_dir", str(shard_dir), "--out_dir", str(out), *CLI_ARGS])
    with open(out / "summary_stats.json") as f:
        assert json.load(f) == summary
    assert _keys(summary) == _study_keys(experiment)


def test_cli_latent_from_the_port_trainer(shard_dir, tmp_path):
    """train_latent -> test --latent_ckpt: the logdir's `best` checkpoint
    (the bounded run's final validation writes it), EMA weights, loaded into
    the denoiser the CLI samples with."""
    from codlad_tpu_torch.cli import train_latent

    write_synthetic_features(str(tmp_path / "features"), 4, 14)
    train_latent.main(["--feature_dir", str(tmp_path / "features"), "--exp",
                       str(tmp_path / "exp"), "--batch_size", "2", "--max_steps", "2",
                       "--dropout", "0", "--device", "cpu"])
    model, cfg = CLI.load_latent_ckpt(str(tmp_path / "exp"), "cpu")
    assert cfg["checkpoint"] == "best" and cfg["step"] == 2
    sd = torch.load(tmp_path / "exp" / "best.pt", weights_only=True)
    for k, v in model.named_parameters():
        torch.testing.assert_close(v.detach(), sd["ema_params"][k], rtol=0, atol=0)
    summary = CLI.main(["--experiment", "latent", "--latent_ckpt", str(tmp_path / "exp"),
                        "--data_dir", str(shard_dir), "--out_dir", str(tmp_path / "eval"),
                        "--no-bf16", *CLI_ARGS])
    assert _keys(summary) == _study_keys("latent")


def test_cli_genzprot_from_the_port_trainer(shard_dir, tmp_path):
    """train_vqvae -train_section ivae -> test --experiment genzprot: draws
    from GenZProt's CG prior, decoded and scored with the study's summary
    keys (those of `latent`)."""
    from codlad_tpu_torch.cli import train_vqvae

    train_vqvae.main(["-data_dir", str(shard_dir), "-logdir", str(tmp_path / "ivae"),
                      "-train_section", "ivae", "-batch_size", "2", "-nepochs", "1",
                      "-enc_nconv", "1", "-dec_nconv", "1", "--device", "cpu"])
    summary = CLI.main(["--experiment", "genzprot", "--vae_ckpt", str(tmp_path / "ivae"),
                        "--data_dir", str(shard_dir), "--out_dir", str(tmp_path / "eval"),
                        "--num_ensemble", "2", "--device", "cpu"])
    assert _keys(summary) == _study_keys("latent")


@pytest.mark.parametrize("flags", [["--seq_shards", "2"]])
def test_cli_refuses_what_is_not_ported(shard_dir, tmp_path, flags):
    args = ["--experiment", "latent", "--latent_weights", WEIGHTS, "--data_dir",
            str(shard_dir), "--out_dir", str(tmp_path / "eval"), *CLI_ARGS, *flags]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        CLI.main(args)


@pytest.mark.parametrize("cfg", [{"distill_tmap": [999, 499]}])
def test_denoiser_config_refuses_what_is_not_ported(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        denoiser_from_config(cfg)


@pytest.mark.parametrize("model,out", [("diffusion", 6), ("sbcfm", 6), ("otcfm", 3),
                                       ("icfm", 3), ("fm", 3), ("vpfm", 3), ("backbone", 3)])
def test_denoiser_config_builds_every_model(model, out):
    """learn_sigma (2C output channels) for diffusion and sbcfm only, as the
    JAX CLI builds its denoiser (codlad_tpu/cli/test.py:219-220)."""
    den = denoiser_from_config({"model": model})
    assert den.w_out.Dense_1.out_features == out


def test_denoiser_config_refuses_a_decoder_mask():
    """JAX's evaluation builds its denoiser without the mask, so such a
    checkpoint cannot be evaluated by either package."""
    with pytest.raises(ValueError, match="decoder_mask"):
        denoiser_from_config({"decoder_mask": True})


def test_cli_latent_needs_a_card_for_cuda(shard_dir, tmp_path):
    with pytest.raises(SystemExit) as exc:
        CLI.main(["--experiment", "latent", "--latent_weights", WEIGHTS, "--vae_weights",
                  VAE_WEIGHTS, "--data_dir", str(shard_dir), "--out_dir",
                  str(tmp_path / "eval")])
    assert exc.value.code != 0
