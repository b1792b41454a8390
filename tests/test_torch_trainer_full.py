"""The Stage-2 trainer's entry point (`codlad_tpu_torch.cli.train_latent`)
with what the JAX trainer has beyond `last` checkpoints, on the CPU at tiny
size: validation weighted by each batch's valid samples, `best` only on a
lower val loss, `--resume` (step, optimizer and the best val loss replayed
from metrics.jsonl; a warning, not a silent fresh start, without a
checkpoint), `--model_ckpt` (weights only), `--max_seconds`,
`--t_sampler loss_second_moment`, `--grad_accum`, the config keys the
evaluation CLIs read, and `cli.test --cfg_scale` on a self-conditioned
run."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from codlad_tpu_torch.cli import test as TEST_CLI
from codlad_tpu_torch.cli import train_latent as CLI
from codlad_tpu_torch.data.cg_batch import write_synthetic_features
from codlad_tpu_torch.data.shards import save_protein_shard
from codlad_tpu_torch.data.synthetic import synthetic_examples
from codlad_tpu_torch.gen import timestep_sampler
from codlad_tpu_torch.train import checkpoints, steps

CLI_VAE = Path(__file__).resolve().parents[1] / "weights" / "convergence_vqvae.npz"
BASE = ["--batch_size", "2", "--log_step", "1", "--warmup", "2", "--dropout", "0.1",
        "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the suite runs this file beside its other
    workers on the same cores, where torch's thread pools oversubscribe
    them; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    """Training features (4 frames of 12 residues) and validation features
    in two files of 3 and 2 frames: at val batch 2 the val batches hold 2,
    1 (padded) and 2 valid samples."""
    d = tmp_path_factory.mktemp("feat")
    write_synthetic_features(str(d / "train"), 4, 12, seed=0)
    write_synthetic_features(str(d / "val"), 5, 12, seed=1, files=2)
    return d


def _run(feats, exp, *extra):
    return CLI.main(["--feature_dir", str(feats / "train"), "--val_dir", str(feats / "val"),
                     "--exp", str(exp), *BASE, *extra])


def _rows(exp, split):
    rows = [json.loads(r) for r in (exp / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if r["split"] == split]


@pytest.fixture
def val_losses(monkeypatch):
    """Replace each validation batch's loss by the next of a list (its
    weight stays the batch's); returns the list to fill, and the
    (loss, weight) pairs eval_step gave."""
    real = steps.make_latent_step
    queue, seen = [], []

    def fake(*a, **k):
        train_step, eval_step = real(*a, **k)

        def ev(*aa, **kk):
            m = eval_step(*aa, **kk)
            if queue:
                m["loss"] = torch.tensor(queue.pop(0))
            seen.append((float(m["loss"]), float(m["weight"])))
            return m
        return train_step, ev

    monkeypatch.setattr(steps, "make_latent_step", fake)
    return queue, seen


@pytest.fixture
def saves(monkeypatch):
    real, out = checkpoints.CheckpointManager.save, []

    def save(self, state, name):
        out.append((name, state.step))
        return real(self, state, name)

    monkeypatch.setattr(checkpoints.CheckpointManager, "save", save)
    return out


def test_validation_is_weighted_by_valid_samples(feats, tmp_path, val_losses):
    _, seen = val_losses
    _run(feats, tmp_path / "e", "--max_steps", "1")
    assert [w for _, w in seen] == [2.0, 1.0, 2.0]
    (row,) = _rows(tmp_path / "e", "val")
    want = sum(l * w for l, w in seen) / sum(w for _, w in seen)
    assert row["step"] == 1 and np.isclose(row["loss"], want, rtol=1e-6)
    assert not np.isclose(row["loss"], np.mean([l for l, _ in seen]), rtol=1e-6)


def test_best_only_on_a_lower_val_loss(feats, tmp_path, val_losses, saves):
    """Validations at epochs 1, 2 and 3 read 5, 7 and 4: `best` is written at
    the first and the third, `last` at every one."""
    queue, _ = val_losses
    queue += [5.0] * 3 + [7.0] * 3 + [4.0] * 3
    _run(feats, tmp_path / "e", "--epochs", "3")
    assert [r["loss"] for r in _rows(tmp_path / "e", "val")] == [5.0, 7.0, 4.0]
    assert [s for s in saves if s[0] == "best"] == [("best", 2), ("best", 6)]
    assert [s for s in saves if s[0] == "last"][:3] == [("last", 2), ("last", 4), ("last", 6)]
    assert torch.load(tmp_path / "e" / "best.pt", weights_only=True)["step"] == 6


def test_resume_restores_the_step_and_replays_the_best_val(feats, tmp_path, val_losses, saves):
    """A run to step 2 (val 3.0), then --resume to step 4 with gradient
    accumulation 2: it restarts at step 2 with the optimizer it saved, and
    its val 4.0 does not replace `best`, chosen against the replayed 3.0."""
    queue, _ = val_losses
    exp = tmp_path / "e"
    queue += [3.0] * 3
    first = _run(feats, exp, "--max_steps", "2", "--grad_accum", "2")
    assert first.step == 2 and first.opt_state["count"] == 1
    queue += [4.0] * 3
    resumed = _run(feats, exp, "--max_steps", "4", "--grad_accum", "2", "--resume")
    log = (exp / "log.txt").read_text()
    assert "resumed at step 2" in log and "replayed from metrics.jsonl: 3.00000" in log
    assert resumed.step == 4 and resumed.opt_state["count"] == 2
    assert [r["step"] for r in _rows(exp, "train")] == [1, 2, 3, 4]
    assert [s for s in saves if s[0] == "best"] == [("best", 2)]
    assert torch.load(exp / "best.pt", weights_only=True)["step"] == 2


def test_resume_without_a_checkpoint_warns_and_starts_fresh(feats, tmp_path):
    state = _run(feats, tmp_path / "e", "--max_steps", "1", "--resume")
    assert state.step == 1
    assert "no checkpoint found" in (tmp_path / "e" / "log.txt").read_text()


def test_model_ckpt_loads_the_weights_and_no_optimizer_state(feats, tmp_path):
    src = _run(feats, tmp_path / "a", "--max_steps", "2")
    warm = _run(feats, tmp_path / "b", "--model_ckpt", str(tmp_path / "a"), "--epochs", "0")
    saved = torch.load(tmp_path / "a" / "best.pt", weights_only=True)
    assert warm.step == 0 and warm.opt_state["count"] == 0
    for k, v in warm.params.items():
        assert torch.equal(v, saved["params"][k]) and torch.equal(warm.ema_params[k],
                                                                  saved["ema_params"][k])
        assert not warm.opt_state["mu"][k].any() and not warm.opt_state["nu"][k].any()
    assert src.opt_state["count"] == 2


def test_max_seconds_saves_validates_and_stops(feats, tmp_path):
    state = _run(feats, tmp_path / "e", "--max_seconds", "1e-9")
    assert state.step == 1
    assert [r["step"] for r in _rows(tmp_path / "e", "val")] == [1]
    assert torch.load(tmp_path / "e" / "last.pt", weights_only=True)["step"] == 1
    assert "wall-clock budget" in (tmp_path / "e" / "log.txt").read_text()


def test_loss_second_moment_sampler_gets_each_steps_valid_losses(feats, tmp_path,
                                                                  monkeypatch):
    """Each step's t come from the resampler with their weights, and the
    step's valid samples' t and losses go back into its history."""
    calls = {"sample": [], "update": []}
    real_sample = timestep_sampler.LossSecondMomentResampler.sample
    real_update = timestep_sampler.LossSecondMomentResampler.update_with_losses

    def sample(self, *a, **k):
        out = real_sample(self, *a, **k)
        calls["sample"].append(out)
        return out

    def update(self, ts, losses):
        calls["update"].append((np.asarray(ts), np.asarray(losses)))
        return real_update(self, ts, losses)

    monkeypatch.setattr(timestep_sampler.LossSecondMomentResampler, "sample", sample)
    monkeypatch.setattr(timestep_sampler.LossSecondMomentResampler, "update_with_losses", update)
    _run(feats, tmp_path / "e", "--max_steps", "3", "--t_sampler", "loss_second_moment")
    assert len(calls["sample"]) == len(calls["update"]) == 3
    for (t_s, w), (t_u, losses) in zip(calls["sample"], calls["update"]):
        np.testing.assert_array_equal(t_s.numpy(), t_u)
        assert torch.equal(w, torch.ones(2))          # uniform until warm
        assert np.all(np.isfinite(losses)) and np.all(losses > 0)


def test_config_carries_the_keys_the_evaluation_reads_and_cfg_sampling_runs(feats, tmp_path):
    """A self-conditioned run's config.json has backbone, model, adaln_mode
    and self_condition; `cli.test --experiment latent --latent_ckpt` builds a
    self-conditioned denoiser from it and samples with guidance."""
    exp = tmp_path / "e"
    _run(feats, exp, "--max_steps", "1", "--self_condition", "--class_dropout_prob", "0.5")
    cfg = json.loads((exp / "config.json").read_text())
    assert {k: cfg[k] for k in ("backbone", "model", "adaln_mode", "self_condition")} == {
        "backbone": "mpnn_diffusion", "model": "diffusion", "adaln_mode": "trunk",
        "self_condition": True}
    model, _ = TEST_CLI.load_latent_ckpt(str(exp), "cpu")
    assert model.self_condition and model.x_in.in_features == 6
    shards = tmp_path / "shards"
    shards.mkdir()
    save_protein_shard(str(shards / "prot_0000.npz"),
                       synthetic_examples(2, 12, seed=0, prot_idx=0, structured=True))
    summary = TEST_CLI.main(["--experiment", "latent", "--latent_ckpt", str(exp),
                             "--vae_weights", str(CLI_VAE), "--data_dir", str(shards),
                             "--out_dir", str(tmp_path / "eval"), "--num_sampling_steps", "3",
                             "--num_ensemble", "1", "--cfg_scale", "1.5", "--device", "cpu"])
    assert all(np.isfinite(v) for v in summary["__global__"].values())
