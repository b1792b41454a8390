"""The port's Stage-2 training pieces against the JAX package on the CPU:
diffusion training losses, the optimizer (clip + AdamW + schedule) and EMA
against optax, the data helpers, checkpoints, and the trainer CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import t
from codlad_tpu.data import norm as JN
from codlad_tpu.data.shards import iter_padded_batches as jax_iter_padded_batches
from codlad_tpu.gen import diffusion as JD
from codlad_tpu.train import state as JS
from codlad_tpu_torch.cli import train_latent as CLI
from codlad_tpu_torch.data import norm as TN
from codlad_tpu_torch.data.cg_batch import write_synthetic_features
from codlad_tpu_torch.data.shards import iter_padded_batches
from codlad_tpu_torch.gen import diffusion as TD
from codlad_tpu_torch.gen.timestep_sampler import UniformSampler
from codlad_tpu_torch.train import state as TS
from codlad_tpu_torch.train.checkpoints import CheckpointManager


def _model_out(xp, x, tt):
    """A fixed stand-in for the network: mean and variance channels."""
    w = (tt.astype(np.float32) if xp is jnp else tt.float()) / 1000.0
    w = w.reshape(-1, 1, 1)
    mean = 0.3 * x + 0.1 * w
    var = xp.tanh(x * (1.0 - w))
    return xp.concatenate([mean, var], axis=-1) if xp is jnp else torch.cat([mean, var], -1)


def test_training_losses_match_jax_including_t0():
    """loss, mse and vb with injected t and noise, a residue mask, t = 0
    (the decoder NLL branch) and t = 999; f32 atol 1e-5 + rtol 1e-5."""
    rng = np.random.default_rng(0)
    B, L = 4, 10
    x0 = rng.normal(size=(B, L, 3)).astype(np.float32)
    noise = rng.normal(size=(B, L, 3)).astype(np.float32)
    mask = np.ones((B, L, 1), np.float32)
    mask[1, 6:] = 0.0
    mask[3, 2:] = 0.0
    steps = np.array([0, 17, 500, 999], np.int64)
    jd = JD.create_diffusion(None, diffusion_steps=1000)
    td = TD.create_diffusion(None, diffusion_steps=1000)
    want = jd.training_losses(jax.random.PRNGKey(0), lambda x, tt, k: _model_out(jnp, x, tt),
                              jnp.asarray(x0), jnp.asarray(steps), mask=jnp.asarray(mask),
                              noise=jnp.asarray(noise))
    got = td.training_losses(lambda x, tt: _model_out(torch, x, tt), t(x0), t(steps),
                             t(noise), mask=t(mask))
    assert set(got) == {"loss", "mse", "vb"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    # the q-sample and the posterior log-variance on their own
    np.testing.assert_allclose(td.q_sample(t(x0), t(steps), t(noise)).numpy(),
                               np.asarray(jd.q_sample(x0, jnp.asarray(steps), noise)),
                               atol=1e-6)
    np.testing.assert_allclose(td.q_posterior(t(x0), t(noise), t(steps))[2].numpy(),
                               np.asarray(jd.q_posterior(x0, noise, jnp.asarray(steps))[2]),
                               rtol=1e-6)


def test_uniform_sampler_is_seeded_and_in_range():
    s = UniformSampler(1000)
    a, w = s.sample(512, torch.Generator().manual_seed(3))
    b, _ = s.sample(512, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 1000
    assert torch.equal(w, torch.ones(512))


@pytest.mark.parametrize("warmup,steps,final", [(10, None, None), (10, 40, 1e-5), (0, None, None)])
def test_schedule_matches_jax(warmup, steps, final):
    jf = JS.warmup_linear_schedule(3e-4, warmup, steps, final)
    tf = TS.warmup_linear_schedule(3e-4, warmup, steps, final)
    for step in (0, 1, 5, 10, 11, 25, 40, 60):
        want = jf(step) if callable(jf) else jf
        np.testing.assert_allclose(float(tf(step)), float(want), rtol=1e-7, atol=0)


def test_optimizer_and_ema_match_optax():
    """Three steps on a toy tree: the first at lr 0 (warmup: optax reads the
    schedule at the count before the update), the second clipped (norm > 1),
    the third unclipped (norm < 1); params, moments and EMA at rtol 1e-6."""
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 5.0, 0.05)]
    sched = JS.warmup_linear_schedule(1e-2, 2)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.0))
    jstate = JS.create_train_state({k: jnp.asarray(v) for k, v in params.items()}, tx,
                                   with_ema=True)
    tstate = TS.TrainState({k: t(v) for k, v in params.items()},
                           TS.warmup_linear_schedule(1e-2, 2), grad_clip=1.0)
    norms = []
    for i, g in enumerate(grads):
        jstate = jstate.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        jstate = jstate.replace(ema_params=JS.update_ema(jstate.ema_params, jstate.params, 0.9))
        tstate.apply_gradients({k: t(v) for k, v in g.items()})
        tstate.update_ema(0.9)
        norms.append(float(TS.global_norm({k: t(v) for k, v in g.items()})))
        for k in params:
            np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
            np.testing.assert_allclose(tstate.ema_params[k].numpy(),
                                       np.asarray(jstate.ema_params[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(tstate.opt_state["nu"][k].numpy(),
                                       np.asarray(jstate.opt_state[1][0].nu[k]), rtol=1e-6,
                                       atol=1e-12)
        if i == 0:  # lr(0) = 0: nothing moved
            for k in params:
                assert torch.equal(tstate.params[k], t(params[k]))
    assert norms[1] > 1.0 > norms[2]


def test_clip_branches_match_optax():
    g = {"w": t(np.array([3.0, 4.0], np.float32))}
    clip = optax.clip_by_global_norm(2.0)
    want = clip.update({"w": jnp.array([3.0, 4.0])}, clip.init(None))[0]["w"]
    np.testing.assert_allclose(TS.clip_by_global_norm(g, 2.0)["w"].numpy(), np.asarray(want),
                               rtol=1e-7)
    assert torch.equal(TS.clip_by_global_norm(g, 6.0)["w"], g["w"])  # norm 5 < 6: as is


def test_norm_and_padded_batches_match_jax(tmp_path):
    mean, std = np.array([1.0, 2.0, 3.0], np.float32), np.array([2.0, 1.0, 4.0], np.float32)
    TN.save_stats(str(tmp_path), "X", mean, std)
    jm, js = JN.load_stats(str(tmp_path), "X")
    tm, ts = TN.load_stats(str(tmp_path), "X")
    np.testing.assert_array_equal(tm, jm)
    x = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(TN.normalize(x, tm, ts), JN.normalize(x, jm, js))
    np.testing.assert_array_equal(TN.normalize(x, tm, ts, norm_in=False),
                                  JN.normalize(x, jm, js, norm_in=False))
    data = {"x": np.arange(14).reshape(7, 2), "res_mask": np.ones((7, 3), bool)}
    idx = np.array([6, 2, 0, 5, 1, 3, 4])
    got = list(iter_padded_batches(data, 3, idx, n_valid=6))
    want = list(jax_iter_padded_batches(data, 3, idx, n_valid=6))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_roundtrip(tmp_path):
    params = {"w": torch.randn(3, 2), "b": torch.randn(2)}
    st = TS.TrainState(params, lambda s: 0.1, grad_clip=1.0)
    st.apply_gradients({k: torch.ones_like(v) for k, v in params.items()})
    st.update_ema(0.5)
    ck = CheckpointManager(str(tmp_path))
    ck.save(st, "last")
    ck.save(st, "best")
    fresh = TS.TrainState(params, lambda s: 0.1, grad_clip=1.0)
    ck.restore(fresh, "best")
    assert fresh.step == 1 and fresh.opt_state["count"] == 1
    for key in ("params", "ema_params"):
        for k in params:
            assert torch.equal(getattr(fresh, key)[k], getattr(st, key)[k])
    for k in params:
        assert torch.equal(fresh.opt_state["mu"][k], st.opt_state["mu"][k])
    assert (tmp_path / "last.pt").exists() and not list(tmp_path.glob("*.tmp"))


def test_train_latent_cli_on_cpu(tmp_path):
    """Three bf16 steps at dropout 0.6 on a tiny synthetic feature set: finite
    logged losses, a `last` checkpoint that restores into a fresh state."""
    feat, stats, exp = tmp_path / "feat", tmp_path / "stats", tmp_path / "exp"
    write_synthetic_features(str(feat), 5, 14, seed=0, files=2)
    TN.save_stats(str(stats), "DEMO", np.zeros(3, np.float32), np.ones(3, np.float32))
    state = CLI.main(["--feature_dir", str(feat), "--exp", str(exp), "--stats_name", "DEMO",
                      "--stats_dir", str(stats), "--batch_size", "2", "--max_steps", "3",
                      "--log_step", "1", "--warmup", "2", "--bf16", "--device", "cpu"])
    assert state.step == 3
    rows = [__import__("json").loads(r) for r in (exp / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if r["split"] == "train"]    # the run ends with a val row
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)
    assert "steps/sec" in (exp / "log.txt").read_text()
    fresh = TS.TrainState({k: torch.zeros_like(v) for k, v in state.params.items()},
                          lambda s: 0.0)
    CheckpointManager(str(exp)).restore(fresh, "last")
    assert fresh.step == 3
    for k, v in state.params.items():
        assert torch.equal(fresh.params[k], v)


def test_train_latent_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_synthetic_features(str(tmp_path / "f"), 2, 8)
    with pytest.raises(SystemExit) as err:
        CLI.main(["--feature_dir", str(tmp_path / "f"), "--exp", str(tmp_path / "e")])
    assert err.value.code != 0


def test_conversion_covers_every_trainable_leaf():
    """The training forward's params (featurizer included) map one to one;
    an extra flax leaf or a missing one is refused by name."""
    from _torch_parity import ca_inputs, denoiser_pair
    from codlad_tpu_torch.convert.from_flax import load_flax
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser

    res_type, cg, mask = ca_inputs(0, 1, 12)
    _, params, port = denoiser_pair(0, res_type, cg, mask)
    names = set(dict(port.named_parameters()))
    for leaf in ("features.Dense_0.weight", "features.LayerNorm_0.weight",
                 "features.LayerNorm_0.bias", "features.PositionalEncodings_0.Dense_0.weight"):
        assert leaf in names
    inner = jax.tree.map(np.asarray, params["params"])
    extra = dict(inner, stray={"kernel": np.zeros((2, 2), np.float32)})
    fresh = lambda: MPNNDenoiser(torch.Generator().manual_seed(0), hidden_dim=32,
                                 edge_features=32, num_encoder_layers=2,
                                 num_decoder_layers=1, k_neighbors=16)
    with pytest.raises(KeyError, match="stray.weight"):
        load_flax(fresh(), extra)
    missing = {k: v for k, v in inner.items() if k != "w_out"}
    with pytest.raises(KeyError, match="w_out"):
        load_flax(fresh(), missing)


def test_eval_step_is_deterministic_and_is_the_dropout_free_loss():
    """eval_step: no dropout, no update; its loss equals a dropout-free
    training step's loss for the same seed (same t and noise)."""
    from _torch_parity import ca_inputs
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.train.steps import make_latent_step

    res_type, cg, mask = ca_inputs(1, 2, 12, n_valid=[12, 9])
    extras = {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}
    x1 = torch.randn((2, 12, 3), generator=torch.Generator().manual_seed(2))
    model = MPNNDenoiser(torch.Generator().manual_seed(0), hidden_dim=32, edge_features=32,
                         num_encoder_layers=1, num_decoder_layers=1, k_neighbors=8)
    process = TD.create_diffusion(None, diffusion_steps=1000)
    state = TS.TrainState(dict(model.named_parameters()), lambda s: 1e-3, grad_clip=1.0)
    _, eval_step = make_latent_step(model, process, dropout=True)
    before = {k: v.clone() for k, v in state.params.items()}
    a, b = eval_step(state, x1, extras, 3), eval_step(state, x1, extras, 3)
    assert float(a["loss"]) == float(b["loss"]) and np.isfinite(float(a["loss"]))
    assert all(torch.equal(before[k], v) for k, v in state.params.items())
    train_nodrop, _ = make_latent_step(model, process, dropout=False)
    _, m = train_nodrop(state, x1, extras, 3)
    np.testing.assert_allclose(float(m["loss"]), float(a["loss"]), rtol=1e-6)
    assert float(eval_step(state, x1, extras, 4)["loss"]) != float(a["loss"])
