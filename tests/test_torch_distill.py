"""Progressive distillation in the port against the JAX package, on the CPU
in f32: every function of gen/distill.py, one `make_distill_step`, and
`cli.distill` -> `cli.test` on the student.

The functions get the same inputs (numpy draws), the same student indices
i_s and the same noise (randomness does not port, so it is injected), and
a model_fn that is the same closed form in both packages. The step's i_s
and noise are JAX's own draws, replayed (codlad_tpu/train/steps.py:391-396
and gen/distill.py:124-126).

Tolerances: the functions' values within 1e-5 x max|value|, their losses
rtol 1e-6. The step's grads within 1e-5 x max|grad| over the parameters;
its loss, mse and grad norm rtol 1e-4 (the featurizer's self-edge
quaternions carry ~3e-4 of f32 noise in both packages, see
tests/test_torch_mpnn.py), the updated params as
tests/test_torch_vqvae_step.py holds them (1e-6 where the grad is not near
zero; AdamW's first step is lr sign(g)), the EMA atol 2e-5 + rtol 1e-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (assert_params_after_step, ca_inputs, exact_gathers, load_flax,
                           random_params, record_grads, t)
from codlad_tpu.gen import diffusion as JD
from codlad_tpu.gen import distill as JX
from codlad_tpu.models import denoiser as jax_denoiser_mod
from codlad_tpu.train.state import create_train_state
from codlad_tpu.train.steps import make_distill_step as jax_make_distill_step
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict
from codlad_tpu_torch.gen import diffusion as TD
from codlad_tpu_torch.gen import distill as TX
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.train.state import TrainState
from codlad_tpu_torch.train.steps import make_distill_step

TEACHERS = ["ddim100", "ddim25", "100", "7"]


def _pair(respacing, learn_sigma=True, predict_xstart=False):
    kw = dict(diffusion_steps=1000, learn_sigma=learn_sigma, predict_xstart=predict_xstart)
    return JD.create_diffusion(respacing, **kw), TD.create_diffusion(respacing, **kw)


def _close(got, want, scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= scale * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("respacing", TEACHERS)
def test_halve_grid(respacing):
    """The student's betas (float64) and timestep map, and two halvings."""
    tj, tp = _pair(respacing)
    for _ in range(2):
        tj, tp = JX.halve(tj), TX.halve(tp)
        np.testing.assert_array_equal(tp.timestep_map.numpy(), np.asarray(tj.timestep_map))
        np.testing.assert_allclose(tp.betas, np.asarray(tj.betas), rtol=1e-15, atol=0)
        assert tp.num_timesteps == tj.num_timesteps


C = 3


def _model_fns(out_channels):
    """The same closed-form 'denoiser' in both packages: an affine map of x
    and the base timestep (no transcendental function, whose last ulp
    differs between the packages' f32 libraries)."""
    w = np.random.default_rng(11).normal(size=(C, out_channels)).astype(np.float32) * 0.5

    def fj(x, tb, rng=None):
        return x @ jnp.asarray(w) + (tb[:, None, None] / 1000.0)

    def fp(x, tb):
        return x @ torch.from_numpy(w) + (tb[:, None, None].float() / 1000.0)

    return fj, fp


def _inputs(B=4, L=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    noise = rng.normal(size=(B, L, C)).astype(np.float32)
    mask = np.ones((B, L, 1), np.float32)
    mask[1, 6:] = 0.0
    return x, noise, mask


@pytest.mark.parametrize("respacing", ["ddim100", "ddim25"])
@pytest.mark.parametrize("learn_sigma", [True, False])
def test_distill_functions(respacing, learn_sigma):
    """ddim_mean, two_step_target, distill_targets and distill_loss_terms on
    the same inputs, i_s covering 0 and the top student index."""
    tj, tp = _pair(respacing, learn_sigma=learn_sigma)
    sj, sp = JX.halve(tj), TX.halve(tp)
    fj, fp = _model_fns(2 * C if learn_sigma else C)
    x, noise, mask = _inputs()
    i_s = np.array([0, 1, sp.num_timesteps - 1, 5], np.int32)
    ti = torch.from_numpy(i_s).long()

    xt_j = tj.q_sample(jnp.asarray(x), jnp.asarray(2 * i_s), jnp.asarray(noise))
    x0 = np.asarray(xt_j) * 0.7
    _close(TX.ddim_mean(tp, t(xt_j), 2 * ti, t(x0)),
           JX.ddim_mean(tj, xt_j, jnp.asarray(2 * i_s), jnp.asarray(x0)))
    _close(TX.two_step_target(tp, fp, t(xt_j), ti),
           JX.two_step_target(tj, fj, jax.random.PRNGKey(0), xt_j, jnp.asarray(i_s)))
    got = TX.distill_targets(tp, sp, fp, t(x), ti, t(noise))
    want = JX.distill_targets(tj, sj, fj, jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(i_s), jnp.asarray(noise))
    for g, w in zip(got, want):
        _close(g, w)
    got = TX.distill_loss_terms(tp, sp, fp, fp, t(x), ti, t(noise), mask=t(mask))
    want = JX.distill_loss_terms(tj, sj, fj, fj, jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(i_s), mask=jnp.asarray(mask),
                                 noise=jnp.asarray(noise))
    for k in ("loss", "mse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_angle_data_wraps():
    """2-channel (angle) latents: x_t, the DDIM map and the loss wrap into
    [-1, 1) as in JAX."""
    tj, tp = _pair("ddim25")
    sj, sp = JX.halve(tj), TX.halve(tp)
    w = np.random.default_rng(3).normal(size=(2, 4)).astype(np.float32)
    fj = lambda x, tb, rng=None: jnp.tanh(x @ jnp.asarray(w)) * 3.0
    fp = lambda x, tb: torch.tanh(x @ torch.from_numpy(w)) * 3.0
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(3, 5, 2)).astype(np.float32)
    noise = (2.5 * rng.normal(size=(3, 5, 2))).astype(np.float32)
    i_s = np.array([0, 4, 11], np.int32)
    got = TX.distill_loss_terms(tp, sp, fp, fp, t(x), torch.from_numpy(i_s).long(), t(noise))
    want = JX.distill_loss_terms(tj, sj, fj, fj, jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(i_s), noise=jnp.asarray(noise))
    for k in ("loss", "mse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# one make_distill_step against JAX's

CFG = dict(hidden_dim=32, edge_features=32, num_encoder_layers=1, num_decoder_layers=1,
           k_neighbors=8)
LR, CLIP, EMA = 1e-3, 1.0, 0.99


@pytest.fixture(scope="module")
def step_pair():
    B, L = 2, 16
    res_type, cg, mask = ca_inputs(4, B, L, n_valid=[16, 11])
    x1 = np.random.default_rng(5).normal(size=(B, L, 3)).astype(np.float32)
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0,
                                            **CFG)
    init_args = (jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32), res_type, cg, mask)
    student = random_params(model, 6, *init_args)
    teacher = random_params(model, 7, *init_args)
    tj = JD.create_diffusion("ddim20", diffusion_steps=1000, learn_sigma=True)
    sj = JX.halve(tj)
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), dropout=0.0, **CFG),
                     student)
    teacher_p = flax_to_state_dict(jax.device_get(teacher))
    tx = optax.chain(record_grads(), optax.clip_by_global_norm(CLIP),
                     optax.adamw(LR, weight_decay=0.0))
    state = create_train_state(student, tx, with_ema=True)
    extras = {"res_type": jnp.asarray(res_type), "cg_xyz": jnp.asarray(cg),
              "mask": jnp.asarray(mask)}
    rng = jax.random.PRNGKey(3)
    k_t, k_loss = jax.random.split(rng)
    i_s = jax.random.randint(k_t, (B,), 0, sj.num_timesteps)
    noise = jax.random.normal(jax.random.split(k_loss)[1], (B, L, 3))
    with pytest.MonkeyPatch.context() as mp:
        exact_gathers(mp)
        step, _ = jax_make_distill_step(model, tj, sj, ema_decay=EMA)
        new, metrics = step(state, teacher, jnp.asarray(x1), extras, rng)
        jax_out = {"loss": float(metrics["loss"]), "mse": float(metrics["mse"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "grads": flax_to_state_dict(jax.device_get(new.opt_state[0])),
                   "params": flax_to_state_dict(jax.device_get(new.params)),
                   "ema": flax_to_state_dict(jax.device_get(new.ema_params))}
    tp = TD.create_diffusion("ddim20", diffusion_steps=1000)
    tstate = TrainState(dict(port.named_parameters()), lambda s: LR, grad_clip=CLIP)
    tstep, _ = make_distill_step(port, tp, TX.halve(tp), ema_decay=EMA)
    tstate, tm = tstep(tstate, teacher_p, t(x1), {"res_type": t(res_type), "cg_xyz": t(cg),
                                                  "mask": t(mask)}, 0,
                       i_s=t(i_s).long(), noise=t(noise))
    return jax_out, tstate, tm


def test_distill_step_loss(step_pair):
    j, _, m = step_pair
    for k in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), j[k], rtol=1e-4, err_msg=k)
    assert float(m["weight"]) == 2.0


def test_distill_step_grads(step_pair):
    j, _, m = step_pair
    assert set(m["grads"]) == set(j["grads"])
    gmax = max(float(np.abs(g.numpy()).max()) for g in j["grads"].values())
    for k, gj in j["grads"].items():
        gj, gp = gj.numpy(), m["grads"][k].numpy()
        assert np.abs(gp - gj).max() <= 1e-5 * gmax, k


def test_distill_step_update(step_pair):
    """Params where the first step's grad is not near zero within 1e-6
    (elsewhere within 2 lr: AdamW's first step is lr sign(g)); the EMA
    (decay 0.99) within atol 2e-5 + rtol 1e-5."""
    j, state, _ = step_pair
    for k, w in j["params"].items():
        assert_params_after_step(state.params[k].numpy(), w.numpy(), j["grads"][k].numpy(),
                                 LR, k)
    for k, w in j["ema"].items():
        np.testing.assert_allclose(state.ema_params[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-5, err_msg=k)


def test_teacher_gets_no_gradient():
    """The teacher's params are read under no_grad: its tensors never
    require grad, and a teacher equal to the student gives the student
    the gradient of its own branch only."""
    B, L = 2, 16
    res_type, cg, mask = ca_inputs(1, B, L)
    port = MPNNDenoiser(torch.Generator().manual_seed(0), dropout=0.0, **CFG)
    tp = TD.create_diffusion("ddim8", diffusion_steps=1000)
    teacher = {k: v.detach().clone().requires_grad_(True) for k, v in port.named_parameters()}
    state = TrainState(dict(port.named_parameters()), lambda s: LR, grad_clip=CLIP)
    step, _ = make_distill_step(port, tp, TX.halve(tp))
    x1 = torch.randn(B, L, 3, generator=torch.Generator().manual_seed(0))
    _, m = step(state, teacher, x1, {"res_type": t(res_type), "cg_xyz": t(cg),
                                     "mask": t(mask)}, 1)
    assert all(v.grad is None for v in teacher.values())
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# cli.distill -> cli.test on the CPU


def test_distill_cli_two_rounds_then_test(tmp_path, monkeypatch):
    """A 2-step teacher of cli.train_latent, two rounds of cli.distill from
    an 8-step DDIM grid (8 -> 4 -> 2): config.json's distill_tmap is JAX's
    twice-halved grid, T4.pt / T2.pt / last.pt exist; cli.test --latent_ckpt
    on the student samples with DDIM on that grid and ignores
    --num_sampling_steps."""
    from codlad_tpu_torch.cli import distill, test as CLI, train_latent
    from codlad_tpu_torch.data.cg_batch import write_synthetic_features
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    from codlad_tpu_torch.eval import harness

    feats = tmp_path / "feats"
    write_synthetic_features(str(feats), 4, 14, seed=0)
    train_latent.main(["--feature_dir", str(feats), "--exp", str(tmp_path / "teacher"),
                       "--batch_size", "2", "--max_steps", "2", "--device", "cpu"])
    distill.main(["--teacher_ckpt", str(tmp_path / "teacher"), "--feature_dir", str(feats),
                  "--exp", str(tmp_path / "student"), "--start_steps", "8", "--rounds", "2",
                  "--steps_per_round", "2", "--batch_size", "2", "--log_step", "1",
                  "--device", "cpu"])
    cfg = json.load(open(tmp_path / "student" / "config.json"))
    grid = JX.halve(JX.halve(JD.create_diffusion("ddim8", diffusion_steps=1000)))
    assert cfg["distill_tmap"] == [int(v) for v in np.asarray(grid.timestep_map)]
    assert cfg["distilled"] and cfg["distill_round"] == 2
    assert cfg["teacher_ckpt"] == str(tmp_path / "teacher")
    for name in ("T4", "T2", "last"):
        assert os.path.isfile(tmp_path / "student" / f"{name}.pt")

    seen = {}

    class Recording(harness.SamplingPipeline):
        def __post_init__(self):
            super().__post_init__()
            seen.update(sampler=self.sampler, tmap=self.process.timestep_map.tolist())

    monkeypatch.setattr(harness, "SamplingPipeline", Recording)
    shards = tmp_path / "shards"
    shards.mkdir()
    save_protein_shard(str(shards / "p0.npz"), synthetic_examples(2, 20, seed=1))
    vae = os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights",
                       "convergence_vqvae.npz")
    summary = CLI.main(["--experiment", "latent", "--vae_weights", vae, "--latent_ckpt",
                        str(tmp_path / "student"), "--data_dir", str(shards), "--out_dir",
                        str(tmp_path / "eval"), "--num_sampling_steps", "100",
                        "--num_ensemble", "1", "--no-bf16", "--device", "cpu"])
    assert seen == {"sampler": "ddim", "tmap": cfg["distill_tmap"]}
    assert np.isfinite(summary["__global__"]["rmsd"])


def test_distill_cli_refuses_other_teachers(tmp_path):
    from codlad_tpu_torch.cli import distill
    from codlad_tpu_torch.train.checkpoints import CheckpointManager
    for cfg, match in (({"model": "otcfm"}, "diffusion teacher"),
                       ({"model": "diffusion", "self_condition": True}, "self-conditioned")):
        CheckpointManager(str(tmp_path)).save_config(cfg)
        with pytest.raises(SystemExit, match=match):
            distill.main(["--teacher_ckpt", str(tmp_path), "--feature_dir", str(tmp_path),
                          "--exp", str(tmp_path / "out"), "--device", "cpu"])
