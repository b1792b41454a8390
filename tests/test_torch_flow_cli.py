"""The flow entry points of the port on the CPU, tiny: `cli.train_latent
--model` and `cli.test --model / --method / --save_pdb / --save_xtc`.

* train_latent --model otcfm and --model sbcfm take a few steps (sbcfm's
  denoiser emits 2C channels), log their losses, validate by token weight
  and save a config that names the model they trained;
* cli.test --model icfm with each --method on the trained icfm run's
  `--latent_ckpt` and the committed VQ-VAE, with --save_pdb --save_xtc: a
  finite summary, and the files parse back (one MODEL and one XTC frame a
  member, the protein's atoms); cli.test --model sbcfm fails, as JAX's does;
* the exports (`export_ensembles`, `write_recon_pdb`) write the bytes JAX's
  writers write from the same coordinates.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from codlad_tpu.cli import test as JCLI
from codlad_tpu.data import pdb as JPDB
from codlad_tpu_torch.cli import test as CLI
from codlad_tpu_torch.cli import train_latent
from codlad_tpu_torch.data.cg_batch import write_synthetic_features
from codlad_tpu_torch.data.pdb import parse_pdb
from codlad_tpu_torch.data.shards import save_protein_shard
from codlad_tpu_torch.data.synthetic import synthetic_examples
from codlad_tpu_torch.data.xtc import read_xtc
from codlad_tpu_torch.geometry import residues as R


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
VAE_WEIGHTS = os.path.join(REPO, "weights", "convergence_vqvae.npz")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("flow_cli")
    (d / "shards").mkdir()
    for i, n_res in enumerate((20, 27)):
        save_protein_shard(str(d / "shards" / f"prot_{i:04d}.npz"),
                           synthetic_examples(2, n_res, seed=i, prot_idx=i, structured=True))
    write_synthetic_features(str(d / "features"), 4, 14)
    return d


def _train(dirs, model, steps=2):
    exp = dirs / f"exp_{model}"
    train_latent.main(["--feature_dir", str(dirs / "features"), "--exp", str(exp),
                       "--model", model, "--batch_size", "2", "--max_steps", str(steps),
                       "--log_step", "1", "--dropout", "0", "--warmup", "10",
                       "--device", "cpu"])
    with open(exp / "metrics.jsonl") as f:
        rows = [json.loads(r) for r in f]
    with open(exp / "config.json") as f:
        return exp, rows, json.load(f)


@pytest.mark.parametrize("model", ["otcfm", "sbcfm"])
def test_train_latent_flow_model(dirs, model):
    _, rows, cfg = _train(dirs, model)
    assert cfg["model"] == model
    train = [r for r in rows if r["split"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) and "mse" not in r for r in train)
    assert ("score" in train[0]) == (model == "sbcfm")
    assert any(r["split"] == "val" and np.isfinite(r["loss"]) for r in rows)


@pytest.fixture(scope="module")
def icfm_run(dirs):
    return _train(dirs, "icfm")[0]


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "dopri5"])
def test_cli_flow_methods_save_pdb_and_xtc(dirs, icfm_run, tmp_path, method):
    out = tmp_path / "eval"
    summary = CLI.main(["--experiment", "latent", "--model", "icfm", "--method", method,
                        "--rtol", "1e-4", "--atol", "1e-4", "--vae_weights", VAE_WEIGHTS,
                        "--latent_ckpt", str(icfm_run), "--data_dir", str(dirs / "shards"),
                        "--out_dir", str(out), "--num_sampling_steps", "2",
                        "--num_ensemble", "2", "--save_pdb", "--save_xtc", "--device", "cpu"])
    assert np.isfinite(summary["__global__"]["rmsd_aligned"])
    for name, n_res in (("prot_0000", 20), ("prot_0001", 27)):
        st = parse_pdb(out / f"{name}_gen.pdb")
        assert st["xyz14"].shape == (2, n_res - 4, 14, 3)
        traj = read_xtc(out / f"{name}_gen.xtc")
        shard = np.load(dirs / "shards" / f"{name}.npz")
        rt = shard["res_type"][0][:int(shard["res_mask"][0].sum())]
        assert traj["xyz"].shape == (2, int(R.ATOM14_EXISTS[rt].sum()), 3)


def test_cli_sbcfm_sampling_fails_as_jax_does(dirs, tmp_path):
    exp, _, _ = _train(dirs, "sbcfm", steps=1)
    with pytest.raises(ValueError, match="channels for a 3-channel ODE state"):
        CLI.main(["--experiment", "latent", "--model", "sbcfm", "--vae_weights", VAE_WEIGHTS,
                  "--latent_ckpt", str(exp), "--data_dir", str(dirs / "shards"),
                  "--out_dir", str(tmp_path / "eval"), "--num_sampling_steps", "2",
                  "--num_ensemble", "1", "--device", "cpu"])


def _structures(n_res, seed, S=3, B=2, L=32):
    rng = np.random.default_rng(seed)
    batch = {"res_type": torch.as_tensor(rng.integers(0, 20, (B, L)).astype(np.int32)),
             "res_mask": torch.as_tensor(np.arange(L)[None].repeat(B, 0) < n_res)}
    return batch, (rng.normal(0, 10, (S, B, L, 14, 3))).astype(np.float32)


@pytest.mark.parametrize("n_res", [18, 32])
def test_exports_equal_jax_writers(tmp_path, n_res):
    batch, structures = _structures(n_res, n_res)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    CLI.export_ensembles(str(tmp_path / "t"), "prot_7.npz", batch, structures, True, True)
    args = types.SimpleNamespace(out_dir=str(tmp_path / "j"), save_pdb=True, save_xtc=True)
    JCLI._export_ensembles(args, "prot_7.npz", {k: v.numpy() for k, v in batch.items()},
                           structures)
    for f in ("prot_7_gen.pdb", "prot_7_gen.xtc"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    # recon's export: the JAX CLI's lines (codlad_tpu/cli/test.py:281-287)
    xyz14 = torch.as_tensor(structures[0])
    CLI.write_recon_pdb(str(tmp_path / "t"), "prot_7.npz", batch, xyz14)
    rt = batch["res_type"].numpy()
    og_res = np.concatenate([rt[:, :1], rt, rt[:, -1:]], axis=1)[0]
    JPDB.write_pdb(str(tmp_path / "j" / "prot_7_recon.pdb"), og_res, np.zeros_like(og_res),
                   structures[0])
    assert ((tmp_path / "t" / "prot_7_recon.pdb").read_bytes()
            == (tmp_path / "j" / "prot_7_recon.pdb").read_bytes())
