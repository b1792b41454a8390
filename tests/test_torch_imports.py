"""The port and chip_smoke.py import nothing of JAX or the JAX package.

In a fresh interpreter whose import system refuses jax, jaxlib, flax,
optax, orbax and codlad_tpu, every module of codlad_tpu_torch and
chip_smoke import, chip_smoke's slice and training phases run on the CPU
at tiny size through the plain versions of the kernels, and its reference
checks run with the CPU standing in for the card; so do its Stage-1 recon
phases (random weights, the trained weights on their fixture, the recon
CLI) and its Stage-1 training phases (steps of make_vqvae_step, the
card-vs-CPU step, the chain train_vqvae -> extract_features ->
train_latent -> test --vae_ckpt), tiny."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "codlad_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("refused: " + name)
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
    try:
        import codlad_tpu.geometry.residues  # numpy-only, still refused
        raise SystemExit("the import blocker let codlad_tpu through")
    except ImportError:
        pass

    import codlad_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(codlad_tpu_torch.__path__,
                                                   "codlad_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke

    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    pipe = chip_smoke.build_pipeline("cpu", 0, hidden=32, layers=1, k=8,
                                     codebook_size=64, respacing="ddim5",
                                     compute_dtype=torch.bfloat16)
    batch = to_device(synthetic_cg_batch(2, 12, seed=0), "cpu")
    out = chip_smoke.run_slice(pipe, batch, torch.Generator().manual_seed(0))
    chip_smoke.check_slice(out, 2, 16)
    assert {"fused_message_sum", "fused_message_edge_lnmod"} <= set(out["launches"])
    assert not any(out["launches"].values()), out["launches"]
    chip_smoke.reference_check(0, device="cpu")

    # the training phases, tiny, with the CPU standing in for the card
    x1, extras = chip_smoke.train_batch(2, 12, 1, "cpu")
    model, state, step = chip_smoke.build_trainer("cpu", 0, hidden=32, layers=1, k=8,
                                                  compute_dtype=torch.bfloat16)
    times, metrics, totals = chip_smoke.run_train(state, step, x1, extras, 0, 3, {},
                                                  traced=1)
    assert state.step == 3 and len(times) == 2 and not any(totals.values()), totals
    assert chip_smoke.train_launches(3, 3, 0.6)["fused_message_edge_lnmod_drop_bwd"] == 3
    rows = chip_smoke.run_train_cli(0, "cpu", n_frames=3, n_res=12, batch=2, steps=2)
    assert len(rows) == 2
    chip_smoke.train_reference(0, device="cpu", hidden=32, layers=1)

    # the Stage-1 recon phases, tiny, with the CPU standing in for the card
    s1 = chip_smoke.stage1_batch(0, "cpu", 2, 20)
    out = chip_smoke.run_recon(chip_smoke.build_recon("cpu", 0), s1)
    chip_smoke.check_recon(out, s1)
    assert not any(out["enc_launches"].values()), out["enc_launches"]
    assert chip_smoke.encoder_launches() == {"edge_gather": 14, "edge_aggregate": 5,
                                             "fused_tp": 10}
    chip_smoke.recon_reference(0, device="cpu")
    chip_smoke.recon_trained("cpu")
    chip_smoke.run_recon_cli(0, "cpu")

    # the Stage-1 training phases, tiny
    assert chip_smoke.stage1_train_launches() == {"edge_gather": 29, "edge_aggregate": 23,
                                                  "fused_tp": 10, "fused_tp_bwd": 10}
    _, state, step = chip_smoke.build_stage1_trainer("cpu", 0, compute_dtype=torch.bfloat16,
                                                     enc=2, dec=2, n_codes=16)
    times, metrics, syncs = chip_smoke.run_stage1_train(state, step, s1, 3, {}, traced=1)
    assert state.step == 3 and len(times) == 2 and len(syncs) == 3
    chip_smoke.stage1_train_reference(0, device="cpu")
    chain = chip_smoke.run_stage1_cli(0, "cpu", n_res=(20, 24), n_frames=2, batch=2, enc=2,
                                      dec=2, codes=16)
    assert chain["train_vqvae"]["epochs"] == ["0", "1", "2"]
    print("imported", len(names), "modules")
""")


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
