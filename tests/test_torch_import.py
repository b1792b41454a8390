"""The reference-checkpoint importer of the port (convert/torch_import.py,
cli/import_checkpoint.py) against the JAX package's, on the CPU.

No reference checkpoint is in the tree, so the state dicts are written in
the reference's layout from flax trees (the inverse map
`_synthesize_n6_state_dict` of tests/test_convert.py, with DDP's `module.`
prefix and a `dist_filter` key): the trained VQ-VAE (N6 layout), a random
port VAE with the angle decoder (K3 / K4) and a random port GenZProt (C2:
N6 plus `prior_net` and the `atom_munet` / `atom_sigmanet` heads). No JAX
model is initialised.

* The port's converters return JAX's keys with values within 1e-7; the
  layout detection and `--modelnum` resolution are JAX's.
* `cli.import_checkpoint` writes a port logdir from each. On the committed
  weights/convergence_vqvae_n6layout.pt, `cli.test --experiment recon
  --vae_ckpt` gives the `--vae_weights weights/convergence_vqvae.npz`
  run's metrics (rtol 1e-5), and on the fixture frames every VQ code of the
  two loads is equal, with latents within 1e-5 and xyz14 within 1e-3 Å
  (f32: the stored weights are the trained ones divided and multiplied
  again by the per-path corrections, so they differ by an ulp, and the
  internal-coordinate chain to xyz14 compounds the ulps; measured up to
  1e-4 Å on the CPU, 1.5e-5 on an H100);
  `extract_features --ckpt` reads the same logdir.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from codlad_tpu.cli.import_checkpoint import resolve_ckpt_file as jax_resolve
from codlad_tpu.convert import torch_import as JTI
from codlad_tpu.convert.e3nn_basis import tp_weight_corrections
from codlad_tpu.models.encoder import irrep_ladder
from codlad_tpu.nn.irreps import Irreps
from codlad_tpu_torch.cli import import_checkpoint as IC
from codlad_tpu_torch.convert import torch_import as PTI
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict, read_flax_npz
from test_convert import _invert_lin, _synthesize_n6_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N6_PT = os.path.join(REPO, "weights", "convergence_vqvae_n6layout.pt")
WEIGHTS = os.path.join(REPO, "weights", "convergence_vqvae.npz")
FIXTURE = os.path.join(REPO, "weights", "convergence_vqvae_fixture.npz")


def flax_tree_of(module):
    """A port module's parameters as the flax-named tree (the inverse of
    convert/from_flax.flax_to_state_dict)."""
    kinds = dict(module.named_modules())
    tree = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        arr = p.detach().numpy().copy()
        owner = kinds[".".join(mods)]
        if leaf == "weight" and isinstance(owner, nn.Linear):
            leaf, arr = "kernel", arr.T.copy()
        elif leaf == "weight" and isinstance(owner, nn.Embedding):
            leaf = "embedding"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return {"params": tree}


def _vq(seed, n=64):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(n, 3)).astype(np.float32)
    return {"codebook": cb, "embed_avg": cb * 0.5,
            "cluster_size": rng.uniform(0.5, 2.0, n).astype(np.float32)}


def _angle_sd(seed=3):
    from codlad_tpu_torch.models.vae import VAE
    vae = VAE(torch.Generator().manual_seed(seed), embed_dim=36, vqdim=3, predict_angle=True)
    return vae, _synthesize_n6_state_dict(flax_tree_of(vae), _vq(seed), angle=True)


def _genzprot_sd(seed=4):
    """A reference-layout GenZProt state dict from a random port GenZProt."""
    from codlad_tpu_torch.models.vae import GenZProt
    model = GenZProt(torch.Generator().manual_seed(seed))
    p = flax_tree_of(model)["params"]
    dummy = {"kernel": np.zeros((36, 3), np.float32), "bias": np.zeros(3, np.float32)}
    sd = _synthesize_n6_state_dict(
        {"params": {"encoder": p["encoder"], "decoder": p["decoder"], "map_in": dummy,
                    "map_out": dummy}}, _vq(seed))
    sd = {k: v for k, v in sd.items() if "map_in" not in k and "map_out" not in k
          and "quantize" not in k}

    def put(name, w, b):
        sd[f"module.{name}.weight"], sd[f"module.{name}.bias"] = torch.tensor(w), torch.tensor(b)

    sh, ladder, pr = Irreps("1x0e + 1x1o + 1x2e"), irrep_ladder(12, 4), p["prior_net"]
    sd["module.prior_net.cg_node_embedding.weight"] = torch.tensor(pr["Embed_0"]["embedding"])
    put("prior_net.cg_edge_embedding.0", *_invert_lin(pr["EdgeEmbed_0"]["Dense_0"]))
    put("prior_net.cg_edge_embedding.3", *_invert_lin(pr["EdgeEmbed_0"]["Dense_1"]))
    for l in range(3):
        m = tp_weight_corrections(ladder[l], sh, ladder[l + 1])
        put(f"prior_net.cg_conv_layers.{l}.fc.0", *_invert_lin(pr[f"TPConv_{l}"]["Dense_0"]))
        put(f"prior_net.cg_conv_layers.{l}.fc.3",
            *_invert_lin(pr[f"TPConv_{l}"]["Dense_1"], m))
    for i, name in enumerate(("mu.0", "mu.2", "sigma.0", "sigma.2")):
        put(f"prior_net.{name}", *_invert_lin(pr[f"Dense_{i}"]))
    for i, name in enumerate(("atom_munet.0", "atom_munet.2", "atom_sigmanet.0",
                              "atom_sigmanet.2")):
        put(name, *_invert_lin(p["head"][f"Dense_{i}"]))
    return model, {k: v.to(torch.float32) for k, v in sd.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7, err_msg=k)


def _np_sd(sd_torch):
    return {k[len("module."):]: v.numpy() for k, v in sd_torch.items() if "dist_filter" not in k}


@pytest.mark.parametrize("layout", ["n6", "angle"])
def test_convert_vae_equals_jax(layout, tmp_path):
    if layout == "n6":
        sd = torch.load(N6_PT, weights_only=True)
    else:
        _, sd = _angle_sd()
        sd = {k: v.to(torch.float32) for k, v in sd.items()}
    path = str(tmp_path / "model.pt")
    torch.save(sd, path)
    loaded = PTI.load_reference_state_dict(path)
    want_sd = JTI.load_reference_state_dict(path)
    assert set(loaded) == set(want_sd) == set(_np_sd(sd))
    assert not any(k.startswith("module.") or "dist_filter" in k for k in loaded)
    assert PTI.is_angle_layout(loaded) == JTI.is_angle_layout(want_sd) == (layout == "angle")
    got, vq = PTI.convert_vae(path)
    want, wvq = JTI.convert_vae(path)
    _assert_trees_equal(got, want)
    _assert_trees_equal(vq, wvq)
    forced, _ = PTI.convert_vae(loaded, predict_angle=layout == "angle")
    _assert_trees_equal(forced, want)


def test_convert_genzprot_equals_jax(tmp_path):
    model, sd = _genzprot_sd()
    path = str(tmp_path / "model.pt")
    torch.save(sd, path)
    got = PTI.convert_genzprot(path)
    _assert_trees_equal(got, JTI.convert_genzprot(path))
    # and the tree is the originating model's, up to the corrections' rounding
    back = flax_to_state_dict(got)
    for k, v in model.named_parameters():
        np.testing.assert_allclose(back[k].numpy(), v.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_modelnum_resolution_equals_jax(tmp_path):
    for n in (-1, 999, 7):
        assert IC.resolve_ckpt_file(str(tmp_path), n) == jax_resolve(str(tmp_path), n)
    assert IC.resolve_ckpt_file(N6_PT, 999) == jax_resolve(N6_PT, 999) == N6_PT


def _params_close(model, other, rtol=1e-6):
    theirs = dict(other.named_parameters())
    for k, v in model.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), theirs[k].detach().numpy(), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def test_import_cli_angle_and_genzprot_logdirs(tmp_path, capsys):
    """A K3 / K4 run directory through --modelnum 999, and a C2 file, each
    into a logdir that cli.test's loader fills with the originating weights."""
    from codlad_tpu_torch.cli.test import load_vae_ckpt
    vae, sd = _angle_sd()
    run = tmp_path / "Vae_vqvaeangle_PDB_ns36_vq3_vq4096"
    run.mkdir()
    torch.save({k: v.to(torch.float32) for k, v in sd.items()}, run / "best_model.pt")
    IC.main(["--torch_ckpt", str(run), "--modelnum", "999", "--kind", "vqvae", "--out",
             str(tmp_path / "k3")])
    out = capsys.readouterr().out
    assert "decoder layout: IC_Decoder_angle (K3/K4)" in out
    assert "(--codebook_size 4096 overridden)" in out
    cfg = json.loads((tmp_path / "k3" / "config.json").read_text())
    assert cfg["predict_angle"] is True and cfg["train_section"] == "vqvae"
    assert cfg["codebook_size"] == 64 and cfg["imported_from"].endswith("best_model.pt")
    got, snap, _ = load_vae_ckpt(str(tmp_path / "k3"), "cpu")
    _params_close(got, vae)
    np.testing.assert_array_equal(snap["vq_state"].codebook.numpy(), _vq(3)["codebook"])
    np.testing.assert_array_equal(snap["vq_state"].cluster_size.numpy(),
                                  _vq(3)["cluster_size"])

    model, sd = _genzprot_sd()
    torch.save(sd, tmp_path / "model.pt")
    IC.main(["--torch_ckpt", str(tmp_path), "--kind", "genzprot", "--out",
             str(tmp_path / "c2")])
    n = sum(p.numel() for p in model.parameters())
    assert f"imported {n:,} parameters from" in capsys.readouterr().out
    got, snap, cfg = load_vae_ckpt(str(tmp_path / "c2"), "cpu")
    assert cfg["train_section"] == "ivae" and snap["vq_state"] is None
    _params_close(got, model)


def _fixture_batch(n_frames=2):
    with np.load(FIXTURE) as fx:
        return {k[len("batch/"):]: torch.as_tensor(fx[k][:n_frames]) for k in fx.files
                if k.startswith("batch/")}


def test_import_n6_file_end_to_end(tmp_path):
    """The committed N6-layout file -> logdir -> recon / extract_features,
    against the converted trained weights."""
    from codlad_tpu_torch.cli import extract_features as EF
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    from codlad_tpu_torch.eval.harness import SamplingPipeline

    logdir = tmp_path / "n6"
    IC.main(["--torch_ckpt", N6_PT, "--kind", "vqvae", "--out", str(logdir)])
    cfg = json.loads((logdir / "config.json").read_text())
    assert cfg["codebook_size"] == 512 and cfg["predict_angle"] is False

    vae_c, snap_c, _ = CLI.load_vae_ckpt(str(logdir), "cpu")
    vae_w, snap_w, _ = CLI.load_vae_weights(WEIGHTS, "cpu")
    _params_close(vae_c, vae_w)
    w = read_flax_npz(WEIGHTS)
    for k in ("codebook", "cluster_size", "embed_avg"):
        np.testing.assert_array_equal(getattr(snap_c["vq_state"], k).numpy(), w[k])
    batch = _fixture_batch()
    mean, std = w["stats"]
    outs = []
    for vae, snap in ((vae_c, snap_c), (vae_w, snap_w)):
        pipe = SamplingPipeline(denoiser=None, process=None, vae=vae,
                                codebook=snap["vq_state"].codebook, norm_mean=mean,
                                norm_std=std)
        with torch.no_grad():
            h = pipe.encode_latents(batch)
            ic, xyz, codes = pipe.decode(batch, pipe.normalise(h), return_codes=True)
        outs.append((h, xyz, codes))
    m = batch["res_mask"].bool()
    assert torch.equal(outs[0][2][m], outs[1][2][m])
    assert (outs[0][0] - outs[1][0]).abs().max() <= 1e-5
    assert (outs[0][1] - outs[1][1]).abs().max() <= 1e-3

    shards = tmp_path / "shards"
    shards.mkdir()
    for i, n_res in enumerate((20, 27)):
        save_protein_shard(str(shards / f"prot_{i:04d}.npz"),
                           synthetic_examples(2, n_res, seed=i, prot_idx=i, structured=True))
    runs = {}
    for flag, src in (("--vae_ckpt", str(logdir)), ("--vae_weights", WEIGHTS)):
        runs[flag] = CLI.main(["--experiment", "recon", flag, src, "--data_dir", str(shards),
                               "--out_dir", str(tmp_path / f"eval{flag}"), "--device", "cpu"])
    a, b = runs["--vae_ckpt"], runs["--vae_weights"]
    assert set(a) == set(b)
    for name in ("prot_0000.npz", "prot_0001.npz", "__global__"):
        for k, v in b[name].items():
            if k.endswith("_sec"):
                continue
            np.testing.assert_allclose(a[name][k], v, rtol=1e-5, atol=1e-6, err_msg=f"{name} {k}")

    EF.main(["--ckpt", str(logdir), "--data_dir", str(shards), "--out_dir",
             str(tmp_path / "feats"), "--device", "cpu"])
    EF.main(["--vae_weights", WEIGHTS, "--data_dir", str(shards), "--out_dir",
             str(tmp_path / "feats_w"), "--device", "cpu"])
    for name in ("prot_0000.npz", "prot_0001.npz"):
        with np.load(tmp_path / "feats" / name) as f, np.load(tmp_path / "feats_w" / name) as g:
            np.testing.assert_allclose(f["latents"], g["latents"], rtol=0, atol=1e-5)


def test_chip_smoke_angle_layout_reads_as_the_reference_layout():
    """chip_smoke's K3 / K4 state dict (the N6 file's encoder, a port angle
    decoder under the reference's names) converts back to that decoder and
    to the N6 file's encoder, key for key."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    sd, dec = chip_smoke.angle_layout_state_dict(torch.load(N6_PT, weights_only=True), 3)
    loaded = _np_sd(sd)
    assert PTI.is_angle_layout(loaded)
    got, vq = PTI.convert_vae(loaded)
    n6, n6_vq = PTI.convert_vae(N6_PT)
    _assert_trees_equal(got["params"]["decoder"], flax_tree_of(dec)["params"])
    _assert_trees_equal({k: v for k, v in got["params"].items() if k != "decoder"},
                        {k: v for k, v in n6["params"].items() if k != "decoder"})
    _assert_trees_equal(vq, n6_vq)
