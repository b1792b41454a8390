"""The rest of Stage 1 through the port's entry points on the CPU.

* `cli.train_vqvae --device cpu` over 2 tiny synthetic shards for each
  section and for quantizers of every state layout: `-train_section ivae`
  (GenZProt), `fgvae`, `fgae`, `-predict_angle -quantize_type fsq_5` (no VQ
  state), `rvq` (a list of 2 codebooks, restored by `-resume`) and
  `headvq` (8 heads): train_log.csv rows finite, the checkpoint's VQ state
  tree of the kind's layout, an unknown `-quantize_type` raising
  ValueError as JAX's Quantizer does.
* `cli.extract_features` on fgvae with and without `--learn_sigma`: one
  draw beside `mu` and `sigma` (and the Stage-2 `FeatureDataset` of both
  packages re-drawing the same x1 from them, in the same order, bit for
  bit), or the mu || sigma concatenation; on rvq / headvq the usage
  histogram counts every stage's or head's code; on fsq it stays zero (no
  VQ state), as in JAX.
* `cli.test --experiment genzprot` (2 members) on the GenZProt run and
  `--experiment recon` on the angle / FSQ and fgvae runs: finite metrics.
"""

import os

import numpy as np
import pytest
import torch

from codlad_tpu.cli.train_latent import FeatureDataset as JaxFeatureDataset
from codlad_tpu_torch.cli import extract_features, train_vqvae
from codlad_tpu_torch.cli import test as test_cli
from codlad_tpu_torch.cli.train_latent import FeatureDataset
from codlad_tpu_torch.data.shards import save_protein_shard
from codlad_tpu_torch.data.synthetic import synthetic_examples

ARGS = ["-batch_size", "2", "-codebook_size", "16", "-enc_nconv", "1", "-dec_nconv", "1",
        "--device", "cpu", "-seed", "5"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("variants")
    os.makedirs(d / "shards")
    for i, n_res in enumerate((20, 24)):
        save_protein_shard(d / "shards" / f"prot_{i:04d}.npz",
                           synthetic_examples(3, n_res, seed=i, prot_idx=i, structured=True))
    return d


def _train(d, name, extra, nepochs=1):
    logdir = d / name
    state = train_vqvae.main(["-data_dir", str(d / "shards"), "-logdir", str(logdir), *ARGS,
                              "-nepochs", str(nepochs), *extra])
    with open(logdir / "train_log.csv") as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    assert [r[0] for r in rows] == [str(e) for e in range(nepochs)]
    assert all(np.isfinite(float(x)) for r in rows for x in r[1:3])
    return logdir, state


def _extract(d, logdir, out, *extra):
    return extract_features.main(["--ckpt", str(logdir), "--data_dir", str(d / "shards"),
                                  "--out_dir", str(d / out), "--batch_size", "2",
                                  "--device", "cpu", *extra])


def _test(d, logdir, experiment, out, *extra):
    summary = test_cli.main(["--experiment", experiment, "--vae_ckpt", str(logdir),
                             "--data_dir", str(d / "shards"), "--out_dir", str(d / out),
                             "--batch_size", "2", "--device", "cpu", *extra])
    assert set(summary) == {"prot_0000.npz", "prot_0001.npz", "__global__", "__global_stats__"}
    assert all(np.isfinite(v) for v in summary["__global__"].values())
    return summary


def _residues(d):
    return sum(int(np.load(d / "shards" / f)["res_mask"].sum())
               for f in ("prot_0000.npz", "prot_0001.npz"))


def test_genzprot_trains_and_samples(shards):
    logdir, state = _train(shards, "ivae", ["-train_section", "ivae"])
    assert state.vq_state is None and state.step > 0
    assert any(k.startswith("prior_net.TPConv_0.") for k in state.params)
    summary = _test(shards, logdir, "genzprot", "eval_genz", "--num_ensemble", "2")
    member = summary["prot_0000.npz"]
    assert len(member["per_ensemble"]) == 2 and np.isfinite(member["div"])
    with pytest.raises(SystemExit):
        _test(shards, logdir, "recon", "eval_bad")


def test_fgvae_features_with_and_without_learn_sigma(shards):
    logdir, state = _train(shards, "fgvae", ["-train_section", "fgvae", "-vqdim", "36"])
    assert state.vq_state is None and any(k.startswith("head.Dense_3") for k in state.params)
    usage = _extract(shards, logdir, "feat")
    assert usage.sum() == 0 and not (shards / "feat" / "codebook_usage.csv").exists()
    z = np.load(shards / "feat" / "prot_0001.npz")
    assert z["mu"].shape == z["sigma"].shape == z["latents"].shape == z["res_mask"].shape + (36,)
    assert (z["sigma"][z["res_mask"].astype(bool)] > 0).all()
    assert not np.array_equal(z["latents"], z["mu"])
    for epoch in range(2):     # both readers draw the same x1 each epoch, in the same order
        if epoch == 0:
            ours = FeatureDataset(str(shards / "feat"), 2, seed=4)
            theirs = JaxFeatureDataset(str(shards / "feat"), 2, seed=4)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert np.array_equal(a["x1"], b["x1"]) and np.array_equal(a["mask"], b["mask"])
    _extract(shards, logdir, "feat_sigma", "--learn_sigma")
    z2 = np.load(shards / "feat_sigma" / "prot_0001.npz")
    assert "mu" not in z2 and z2["latents"].shape[-1] == 72
    np.testing.assert_allclose(z2["latents"], np.concatenate([z["mu"], z["sigma"]], -1),
                               rtol=1e-6, atol=1e-6)
    _test(shards, logdir, "recon", "eval_fgvae")


def test_fgae_trains(shards):
    logdir, state = _train(shards, "fgae", ["-train_section", "fgae", "-vqdim", "36"])
    assert state.vq_state is None and not any(k.startswith("head.") for k in state.params)
    _test(shards, logdir, "recon", "eval_fgae")


def test_angle_decoder_with_fsq_chain(shards):
    logdir, state = _train(shards, "angle_fsq", ["-predict_angle", "-quantize_type", "fsq_5",
                                                 "-vqdim", "5"])
    assert state.vq_state is None
    assert any(k.startswith("decoder._MLP2_5.") for k in state.params)     # F + 10 blocks
    assert not any(k.startswith("decoder.Embed_3") for k in state.params)
    sd = torch.load(logdir / "last.pt", weights_only=True)
    assert sd["vq_state"] is None
    usage = _extract(shards, logdir, "feat_fsq", "--stats_name", "F", "--stats_dir",
                     str(shards / "stats"))
    assert usage.sum() == 0 and np.load(shards / "feat_fsq" / "prot_0000.npz")["latents"].shape[
        -1] == 5
    _test(shards, logdir, "recon", "eval_fsq", "--stats_name", "F", "--stats_dir",
          str(shards / "stats"))


@pytest.mark.parametrize("qtype,vqdim,n_books", [("rvq", "3", 2), ("headvq", "8", 8)])
def test_multi_codebook_quantizers(shards, qtype, vqdim, n_books):
    logdir, state = _train(shards, qtype, ["-quantize_type", qtype, "-vqdim", vqdim])
    assert isinstance(state.vq_state, list) and len(state.vq_state) == n_books
    sd = torch.load(logdir / "last.pt", weights_only=True)
    assert len(sd["vq_state"]) == n_books
    for got, saved in zip(state.vq_state, sd["vq_state"]):
        assert torch.equal(got.codebook, saved["codebook"])
    usage = _extract(shards, logdir, f"feat_{qtype}")
    assert usage.sum() == _residues(shards) * n_books
    if qtype == "rvq":
        resumed = train_vqvae.main(["-data_dir", str(shards / "shards"), "-logdir", str(logdir),
                                    *ARGS, "-nepochs", "2", "-resume", "-quantize_type", qtype,
                                    "-vqdim", vqdim])
        assert resumed.step == 2 * state.step and len(resumed.vq_state) == n_books


def test_unknown_quantize_type_raises(shards):
    with pytest.raises(ValueError, match="unknown quantize_type"):
        _train(shards, "bad", ["-quantize_type", "pq"])
