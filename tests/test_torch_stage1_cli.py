"""The Stage-1 entry points of the port on the CPU, and its mixed batches.

* `MixedShardDataset` against the JAX one on the same shards and seed (two
  padding buckets, a pool small enough to drain mid-bucket): the same
  batches, in the same order, bit for bit, two epochs running.
* `python -m codlad_tpu_torch.cli.train_vqvae --device cpu` over 2 tiny
  synthetic shards for 2 epochs: train_log.csv rows for epochs 0 and 1,
  `best`, `last` and `epoch_0` checkpoints; `-resume` with -nepochs 3
  continues at epoch 2 with the selection state replayed and the state
  restored (the step count carries on).
* `cli.extract_features` on that checkpoint writes per-protein feature
  files that the port's and the JAX package's Stage-2 `FeatureDataset`
  both read, the stats and the codebook usage; `cli.test --experiment
  recon --vae_ckpt` scores the checkpoint.
* Without a card, `--device cuda` exits non-zero in both new CLIs.
"""

import json
import os

import numpy as np
import pytest
import torch

from codlad_tpu.cli.train_latent import FeatureDataset as JaxFeatureDataset
from codlad_tpu.data.shards import MixedShardDataset as JaxMixed
from codlad_tpu.data.shards import save_protein_shard as jax_save_shard
from codlad_tpu.data.synthetic import synthetic_examples as jax_examples
from codlad_tpu_torch.cli import extract_features, train_vqvae
from codlad_tpu_torch.cli import test as test_cli
from codlad_tpu_torch.cli.train_latent import FeatureDataset
from codlad_tpu_torch.data.shards import MixedShardDataset, save_protein_shard
from codlad_tpu_torch.data.synthetic import synthetic_examples
from codlad_tpu_torch.train.checkpoints import CheckpointManager


def test_mixed_batches_match_jax(tmp_path):
    for i, (n_frames, n_res) in enumerate(((3, 20), (4, 22), (2, 40), (5, 24))):
        jax_save_shard(tmp_path / f"prot_{i:04d}.npz",
                       jax_examples(n_frames, n_res, seed=i, prot_idx=i))
    ours = MixedShardDataset(str(tmp_path), 2, seed=7, pool_frames=5)
    theirs = JaxMixed(str(tmp_path), 2, seed=7, pool_frames=5)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


ARGS = ["-batch_size", "2", "-vqdim", "3", "-codebook_size", "16", "-enc_nconv", "2",
        "-dec_nconv", "2", "-save_every_epochs", "5", "--device", "cpu", "-seed", "3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two shards, a 2-epoch run and a resumed third epoch."""
    d = tmp_path_factory.mktemp("stage1")
    os.makedirs(d / "shards")
    for i, n_res in enumerate((20, 24)):
        save_protein_shard(d / "shards" / f"prot_{i:04d}.npz",
                           synthetic_examples(3, n_res, seed=i, prot_idx=i, structured=True))
    common = ["-data_dir", str(d / "shards"), "-logdir", str(d / "vq"), *ARGS]
    first = train_vqvae.main(common + ["-nepochs", "2"])
    with open(d / "vq" / "train_log.csv") as f:
        rows_first = f.read().splitlines()
    steps_first = first.step
    resumed = train_vqvae.main(common + ["-nepochs", "3", "-resume"])
    return d, rows_first, steps_first, resumed


def test_train_vqvae_runs_and_resumes(run):
    d, rows_first, steps_first, resumed = run
    assert rows_first[0].split(",")[:3] == ["epoch", "train_loss", "val_loss"]
    assert [r.split(",")[0] for r in rows_first[1:]] == ["0", "1"]
    ckpt = CheckpointManager(str(d / "vq"))
    assert ckpt.exists("best") and ckpt.exists("last") and ckpt.exists("epoch_0")
    assert ckpt.available_snapshots("epoch") == [0] and ckpt.best_resume_name("epoch") == "last"
    # 6 frames in batches of 2 mixed within each of the 2 padding buckets
    assert steps_first > 0 and resumed.step == steps_first * 3 // 2
    with open(d / "vq" / "train_log.csv") as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    assert [r[0] for r in rows] == ["0", "1", "2"]
    assert all(np.isfinite(float(x)) for r in rows for x in r[1:3])
    with open(d / "vq" / "log.txt") as f:
        log = f.read()
    assert "resuming at epoch 2" in log and "selection state replayed from 2" in log
    cfg = ckpt.load_config()
    assert (cfg["vqdim"], cfg["codebook_size"], cfg["train_section"]) == (3, 16, "vqvae")
    assert resumed.vq_state.codebook.shape == (16, 3) and resumed.ema_params is None


def test_extract_features_feeds_both_stage2_readers(run):
    d = run[0]
    usage = extract_features.main(["--ckpt", str(d / "vq"), "--data_dir", str(d / "shards"),
                                   "--out_dir", str(d / "feat"), "--stats_name", "T",
                                   "--stats_dir", str(d / "stats"), "--batch_size", "2",
                                   "--device", "cpu"])
    assert usage.sum() == sum(np.load(d / "shards" / f)["res_mask"].sum()
                              for f in ("prot_0000.npz", "prot_0001.npz"))
    assert np.array_equal(np.load(d / "feat" / "codebook_usage.npy"), usage)
    z = np.load(d / "feat" / "prot_0001.npz")
    assert z["latents"].shape == z["res_mask"].shape + (3,) and z["latents"].dtype == np.float32
    stats = np.load(d / "stats" / "T_stats.npz")
    valid = np.concatenate([np.load(d / "feat" / f)["latents"][np.load(d / "feat" / f)
                                                                ["res_mask"].astype(bool)]
                            for f in ("prot_0000.npz", "prot_0001.npz")])
    np.testing.assert_allclose(stats["mean"], valid.mean(0), rtol=1e-6)
    with open(d / "feat" / "manifest.json") as f:
        assert json.load(f)["files"] == ["prot_0000.npz", "prot_0001.npz"]
    for ds in (FeatureDataset(str(d / "feat"), 2, seed=0),
               JaxFeatureDataset(str(d / "feat"), 2, seed=0)):
        batches = list(ds)
        assert len(batches) == 4
        assert all(b["x1"].shape[-1] == 3 and np.isfinite(b["x1"]).all() for b in batches)


def test_recon_cli_scores_the_checkpoint(run):
    d = run[0]
    summary = test_cli.main(["--experiment", "recon", "--vae_ckpt", str(d / "vq"),
                             "--data_dir", str(d / "shards"), "--out_dir", str(d / "eval"),
                             "--batch_size", "2", "--device", "cpu"])
    assert set(summary) == {"prot_0000.npz", "prot_0001.npz", "__global__", "__global_stats__"}
    assert all(np.isfinite(v) for v in summary["__global__"].values())
    with open(d / "eval" / "summary_stats.json") as f:
        assert json.load(f)["__global__"]["rmsd_aligned"] == summary["__global__"]["rmsd_aligned"]


def test_cuda_without_a_card_exits_nonzero(run, monkeypatch):
    d = run[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_vqvae.main(["-data_dir", str(d / "shards"), "-logdir", str(d / "cuda"),
                          "--device", "cuda"])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        extract_features.main(["--ckpt", str(d / "vq"), "--data_dir", str(d / "shards"),
                               "--out_dir", str(d / "cuda_feat"), "--device", "cuda"])
    assert e.value.code not in (0, None)


def test_unported_sections_raise(run):
    d = run[0]
    for extra in (["-train_section", "fgvae"], ["-quantize_type", "fsq"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            train_vqvae.main(["-data_dir", str(d / "shards"), "-logdir", str(d / "x"),
                              "--device", "cpu", *extra])
