"""The port's parallel entry points on spawned gloo ranks
(tests/_torch_dist_worker.py), on the CPU: cli.train_latent on 2 ranks,
whose --record_data covers every row once an epoch (as
tests/test_multihost_cli.py holds the JAX trainer); cli.train_vqvae -dp on
2 ranks against 1 rank (params within 1e-5 x max|param| and the codebook
within 2e-5 after an epoch); cli.test --seq_shards 2 against the dense CLI
(DDIM, the summary's metrics rtol 1e-4); and the twin of
__graft_entry__.dryrun_multichip (parallel/dryrun.py) on 4 ranks, which
holds each of its configurations itself."""

import json
import os

import numpy as np
import torch

from _torch_dist_worker import spawn
from codlad_tpu_torch.data.cg_batch import write_synthetic_features


def test_train_latent_cli_two_ranks_cover_every_row(tmp_path):
    """Two data ranks, 2 epochs of a 7-frame file at global batch 4: each
    epoch every row is consumed once over the ranks' --record_data files;
    rank 0 alone writes the run's files."""
    feats = tmp_path / "feats"
    write_synthetic_features(str(feats), 7, 16, seed=0)
    rec = tmp_path / "rec"
    argv = ["--feature_dir", str(feats), "--exp", str(tmp_path / "exp"), "--batch_size", "4",
            "--epochs", "2", "--warmup", "1", "--log_step", "1", "--val_every_epochs", "2",
            "--record_data", str(rec), "--device", "cpu", "--dropout", "0.6"]
    spawn(2, "cli_case", tmp_path / "ranks", module="codlad_tpu_torch.cli.train_latent",
          argv=argv)
    rows = []
    for r in range(2):
        rows += open(f"{rec}.p{r}").read().split()
    names = sorted(f for f in os.listdir(feats) if f.endswith(".npz"))
    want = sorted(f"{f}:{i}" for f in names for i in range(7)) * 2
    assert sorted(rows) == sorted(want)
    assert os.path.isfile(tmp_path / "exp" / "last.pt")
    logged = [json.loads(line) for line in open(tmp_path / "exp" / "metrics.jsonl")]
    assert sum(1 for r in logged if r["split"] == "train") == 4   # 2 steps an epoch, once


def test_train_vqvae_dp_two_ranks(tmp_path):
    """cli.train_vqvae -dp on 2 ranks trains the 1-rank run's weights (an
    odd -batch_size rounded up to the ranks, both runs given that size)."""
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    data = tmp_path / "shards"
    data.mkdir()
    for i, n in enumerate((20, 24)):
        save_protein_shard(str(data / f"p{i}.npz"), synthetic_examples(3, n, seed=i))
    base = ["-data_dir", str(data), "-enc_nconv", "1", "-dec_nconv", "1",
            "-codebook_size", "16", "-vqdim", "3", "-nepochs", "1", "--device", "cpu"]
    from codlad_tpu_torch.cli import train_vqvae
    train_vqvae.main(base + ["-logdir", str(tmp_path / "one"), "-batch_size", "4"])
    spawn(2, "cli_case", tmp_path / "r2", module="codlad_tpu_torch.cli.train_vqvae",
          argv=base + ["-logdir", str(tmp_path / "two"), "-batch_size", "3"])
    assert json.load(open(tmp_path / "two" / "config.json"))["batch_size"] == 4
    a = torch.load(tmp_path / "one" / "last.pt", weights_only=True)
    b = torch.load(tmp_path / "two" / "last.pt", weights_only=True)
    pmax = max(float(v.abs().max()) for v in a["params"].values())
    for k, v in a["params"].items():
        assert float((b["params"][k] - v).abs().max()) <= 1e-5 * pmax, k
    for k, v in a["vq_state"].items():
        np.testing.assert_allclose(b["vq_state"][k].numpy(), v.numpy(), atol=2e-5)


def test_cli_test_seq_shards_matches_dense(tmp_path):
    """cli.test --seq_shards 2 (2 gloo ranks, DDIM) against the dense CLI on a
    model trained for 2 steps: the same summary."""
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.cli import train_latent
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    weights = os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights",
                           "convergence_vqvae.npz")
    shards = tmp_path / "shards"
    shards.mkdir()
    save_protein_shard(str(shards / "p0.npz"), synthetic_examples(2, 30, seed=1))
    feats = tmp_path / "feats"
    write_synthetic_features(str(feats), 4, 16, seed=0)
    train_latent.main(["--feature_dir", str(feats), "--exp", str(tmp_path / "lat"),
                       "--batch_size", "2", "--max_steps", "2", "--device", "cpu"])
    argv = ["--experiment", "latent", "--vae_weights", weights, "--latent_ckpt",
            str(tmp_path / "lat"), "--data_dir", str(shards), "--num_sampling_steps", "3",
            "--num_ensemble", "2", "--sampler", "ddim", "--no-bf16", "--device", "cpu"]
    dense = CLI.main(argv + ["--out_dir", str(tmp_path / "dense")])
    sharded = spawn(2, "cli_case", tmp_path / "ranks", module="codlad_tpu_torch.cli.test",
                    argv=argv + ["--out_dir", str(tmp_path / "seq"), "--seq_shards", "2"])
    for k, v in dense["p0.npz"].items():
        if np.isscalar(v) and k != "wallclock_sec":
            for r in sharded:
                np.testing.assert_allclose(r["p0.npz"][k], v, rtol=1e-4, atol=1e-5,
                                           err_msg=k)


def test_dryrun_twin(tmp_path):
    res = spawn(4, "dryrun_case", tmp_path)
    assert set(res[0]) == {"dp", "dp_x_sp_train", "seq_forward", "stage1_dp", "dp_x_tp"}
