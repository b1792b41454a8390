"""The port and chip_smoke.py import nothing of JAX or the JAX package.

In a fresh interpreter whose import system refuses jax, jaxlib, flax,
optax, orbax and codlad_tpu, every module of codlad_tpu_torch and
chip_smoke import, chip_smoke's slice and training phases run on the CPU
at tiny size through the plain versions of the kernels, and its reference
checks run with the CPU standing in for the card (both adaLN modes, and the
pair-fused scans); so do its Stage-1 recon
phases (random weights, the trained weights on their fixture, the recon
CLI) and its Stage-1 training phases (steps of make_vqvae_step, the
card-vs-CPU step, the chain train_vqvae -> extract_features ->
train_latent -> test --vae_ckpt), tiny; and the trained Stage-2 phases (the
converted denoiser on its JAX fixture, `cli.test --experiment latent` and
`prior`, a bf16 draw), which fail without their weights file; and the
whole Stage-2 trainer's and guided sampling's phases (the trainer CLI with
every new flag, remat's memory, the accumulated self-conditioned step card
against CPU, a guided self-conditioned draw with its kernel calls checked,
the small f32 guided and masked draws, the guided latent CLI), tiny; and
the phase of the rest of Stage 1 (GenZProt's steps, GenZProt, the angle
VQ-VAE and fgvae card vs CPU, one step of each quantizer kind, the chain
ivae -> genzprot, angle / fsq -> extract -> recon, fgvae -> extract
--learn_sigma), tiny; and the flows phase's parts (the native host
library loaded and checked, a flow draw by each solver, the f32 reference
draws, otcfm and sbcfm steps and their card-vs-CPU step, the user path
preprocess -> train_latent --model otcfm -> cli.test --save_pdb --save_xtc),
tiny; and the distill and parallel phases' parts (distillation steps and
their card-vs-CPU step, the distillation user path, the trainers in and out
of a process group of one rank, the seq-mode checks, the dryrun twin), tiny."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = textwrap.dedent("""
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
    # one thread: the suite runs this beside its other workers on the same
    # cores, where torch's thread pools oversubscribe them
    torch.set_num_threads(1)
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    batch = to_device(synthetic_cg_batch(2, 12, seed=0), "cpu")
    x1, extras = chip_smoke.train_batch(2, 12, 1, "cpu")
""")

SCRIPT = BLOCKER + textwrap.dedent("""
    pipe = chip_smoke.build_pipeline("cpu", 0, hidden=32, layers=1, k=8,
                                     codebook_size=64, respacing="ddim5",
                                     compute_dtype=torch.bfloat16)
    out = chip_smoke.run_slice(pipe, batch, torch.Generator().manual_seed(0))
    chip_smoke.check_slice(out, 2, 16)
    assert {"fused_message_sum", "fused_message_edge_lnmod"} <= set(out["launches"])
    assert not any(out["launches"].values()), out["launches"]
    chip_smoke.reference_check(0, device="cpu")

    # the pair-fused scans and the residual sampling path, tiny
    fs = chip_smoke.fused_scans(pipe, batch, 0, rounds=2)
    assert fs["launches"] == dict.fromkeys(fs["launches"], 0), fs["launches"]
    assert len(fs["fused_s"]) == len(fs["unfused_s"]) == 2 and fs["steps"] == 5
    assert fs["latents_d"] <= chip_smoke.FUSE_TOL * fs["latents_scale"], fs
    assert fs["first_d"] <= chip_smoke.FUSE_TOL * fs["first_scale"], fs
    assert fs["first_equal"] and fs["latents_equal"], fs
    assert chip_smoke.trace_sampling(pipe, batch, 0, n=1) == set()  # no device here
    res = chip_smoke.build_pipeline("cpu", 0, hidden=32, layers=1, k=8, codebook_size=64,
                                    respacing="ddim5", compute_dtype=torch.bfloat16,
                                    adaln_mode="residual")
    out = chip_smoke.run_slice(res, batch, torch.Generator().manual_seed(0))
    chip_smoke.check_slice(out, 2, 16)
    chip_smoke.reference_check(0, device="cpu", adaln_mode="residual")

    # the training phases, tiny, with the CPU standing in for the card
    model, state, step = chip_smoke.build_trainer("cpu", 0, hidden=32, layers=1, k=8,
                                                  compute_dtype=torch.bfloat16)
    times, metrics, totals = chip_smoke.run_train(state, step, x1, extras, 0, 3, {},
                                                  traced=1)
    assert state.step == 3 and len(times) == 2 and not any(totals.values()), totals
    assert chip_smoke.train_launches(3, 3, 0.6)["fused_message_edge_lnmod_drop_bwd"] == 3
    rows = chip_smoke.run_train_cli(0, "cpu", n_frames=3, n_res=12, batch=2, steps=2)
    assert len(rows) == 2
    chip_smoke.train_reference(0, device="cpu", hidden=32, layers=1)
    assert chip_smoke.train_launches(3, 3, 0.6, "residual") == {
        "fused_message_sum": 6, "fused_message_edge": 3, "fused_message_sum_bwd": 6,
        "fused_message_edge_bwd": 3}
    model, state, step = chip_smoke.build_trainer("cpu", 0, hidden=32, layers=1, k=8,
                                                  compute_dtype=torch.bfloat16, gates=True,
                                                  adaln_mode="residual")
    times, metrics, totals = chip_smoke.run_train(state, step, x1, extras, 0, 2, {},
                                                  traced=1)
    assert state.step == 2 and not any(totals.values()), totals
    chip_smoke.train_reference(0, device="cpu", hidden=32, layers=1, dropout=0.0,
                               adaln_mode="residual")
    rows = chip_smoke.run_train_cli(0, "cpu", n_frames=3, n_res=12, batch=2, steps=2,
                                    adaln_mode="residual")
    assert len(rows) == 2

    print("imported", len(names), "modules")
""")

# the later phases in processes of their own: one script for all of them
# ran close to its 300 s limit beside the suite's other workers
STAGE1_SCRIPT = BLOCKER + textwrap.dedent("""
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

    print("Stage-1 phases rehearsed")
""")

TRAINED_SCRIPT = BLOCKER + textwrap.dedent("""
    s1 = chip_smoke.stage1_batch(0, "cpu", 2, 20)
    # the trained Stage-2 phases, tiny: the f32 fixture check, the latent and
    # prior CLI (no hold at this size), a bf16 draw; a missing weights file
    # fails the phase
    chip_smoke.latent_trained("cpu", n_frames=2, steps="5", cpu_check=False)
    cli = chip_smoke.run_latent_cli("cpu", n_frames=2, steps=3, ensemble=2)
    assert set(cli["shards"]) == set(chip_smoke.JAX_EVAL)
    assert chip_smoke.check_latent_cli(cli, 3, 2, cuda=False, hold=False) == []
    pipe = chip_smoke.trained_pipeline("cpu", torch.bfloat16, steps="ddim3")
    b = {k: torch.as_tensor(v) for k, v in cli["shards"]["prot_0030.npz"].items()}
    chip_smoke.check_slice(chip_smoke.run_slice(pipe, b, torch.Generator().manual_seed(0)),
                           2, 64)
    calls = chip_smoke.check_trained_calls(pipe, b, torch.Generator().manual_seed(0))
    assert {k: v[0] for k, v in calls.items()} == {
        "fused_message_sum": 12, "fused_message_edge_lnmod": 6, "edge_gather": 6,
        "edge_aggregate": 4} and not any(v[2] for v in calls.values()), calls
    assert all(len(v) == 5 and v[4] > 0 for v in calls.values()), calls   # max|ref| logged

    # the whole Stage-2 trainer and guided, self-conditioned sampling, tiny
    assert chip_smoke.full_train_launches(True, True) == {
        "fused_message_sum": 18, "fused_message_edge_lnmod_drop": 9,
        "fused_message_sum_bwd": 6, "fused_message_edge_lnmod_drop_bwd": 3}
    assert chip_smoke.full_train_launches(False, False)["fused_message_sum"] == 6
    full = chip_smoke.run_train_full_cli(0, "cpu", n_frames=3, n_res=12, batch=2, steps=4,
                                         resume_to=6, warm=2)
    assert len(full["ms"]) == 4 and full["val"] and set(full["coins"]) <= {True, False}
    mem = chip_smoke.remat_memory(0, "cpu", n_frames=2, n_res=12, hidden=32, layers=1, k=8,
                                  steps=1)
    assert set(mem) == {False, True}
    chip_smoke.train_full_reference(0, device="cpu", hidden=32, layers=1)
    gp = chip_smoke.build_pipeline("cpu", 0, hidden=32, layers=1, k=8, codebook_size=64,
                                   respacing="ddim5", compute_dtype=torch.bfloat16,
                                   self_condition=True, cfg_scale=1.5)
    assert gp.denoiser.x_in.in_features == 6
    out = chip_smoke.run_slice(gp, batch, torch.Generator().manual_seed(0))
    chip_smoke.check_slice(out, 2, 16)
    calls = chip_smoke.check_trained_calls(gp, batch, torch.Generator().manual_seed(0))
    assert calls["fused_message_sum"][:4] == [4, 0.0, 0, (4, 16, 8)], calls
    chip_smoke.guided_reference(0, device="cpu", n_frames=2, n_res=16, hidden=32, layers=1)
    summary, sec, _ = chip_smoke.run_guided_cli("cpu", n_frames=2, steps=3, ensemble=2)
    assert summary["rmsd_aligned"] > 0 and sec > 0

    # the rest of Stage 1, tiny: CGPrior's launches, GenZProt's steps, the
    # three sections card vs CPU, each quantizer kind, the entry chain
    assert "codlad_tpu_torch.models.prior" in names
    assert chip_smoke.cgprior_launches() == {"edge_gather": 8, "edge_aggregate": 3,
                                             "fused_tp": 3}
    assert chip_smoke.cgprior_launches(train=True) == {
        "edge_gather": 11, "edge_aggregate": 9, "fused_tp": 3, "fused_tp_bwd": 3}
    _, state, step = chip_smoke.build_variant_trainer(
        "cpu", 0, ["-train_section", "ivae", "-enc_nconv", "1", "-dec_nconv", "1"])
    times, metrics, _ = chip_smoke.run_stage1_train(state, step, s1, 2, {})
    assert state.step == 2 and float(metrics["kl"]) >= 0
    chip_smoke.variant_reference(0, "cpu", n_frames=2, n_res=20, enc=1, dec=1)
    assert set(chip_smoke.run_quantizer_kinds(0, "cpu", n_res=20)) == set(
        chip_smoke.QUANTIZER_KINDS)
    chain = chip_smoke.run_variant_cli(0, "cpu", n_res=(20, 24), n_frames=2, batch=2, enc=1,
                                       dec=1, codes=16)
    assert chain["extract_learn_sigma"]["width"] == 72

    chip_smoke.LATENT_WEIGHTS = chip_smoke.LATENT_WEIGHTS.with_name("missing.npz")
    try:
        chip_smoke.latent_trained("cpu", n_frames=2, steps="5", cpu_check=False)
        raise SystemExit("latent_trained ran without its weights file")
    except FileNotFoundError:
        pass
    print("later phases rehearsed")
""")


FLOWS_SCRIPT = BLOCKER + textwrap.dedent("""
    # flow matching and the data I/O, tiny: the native checks, a draw by every
    # solver, the f32 reference draws, otcfm / sbcfm steps and their
    # reference, the user path preprocess -> train_latent -> cli.test
    for name in ("native", "data.pdb", "data.xtc", "data.prefetch", "cli.preprocess",
                 "gen.flow", "gen.ot", "gen.solvers"):
        assert "codlad_tpu_torch." + name in names, name
    from codlad_tpu_torch import native
    assert native.loaded(), native.load_error()
    chip_smoke.native_checks(0, n_points=200)
    fp = chip_smoke.build_flow_pipeline("cpu", 0, hidden=32, layers=1, k=8, codebook_size=64,
                                        compute_dtype=torch.bfloat16)
    for method, steps in (("euler", 2), ("midpoint", 1), ("rk4", 1), ("dopri5", 1)):
        fp.ode_method, fp.ode_steps = method, steps
        chip_smoke.check_slice(chip_smoke.run_slice(fp, batch, torch.Generator().manual_seed(0)),
                               2, 16)
        assert fp.last_ode["nfe"] > 0, fp.last_ode
    assert chip_smoke.flow_launches(4) == {"fused_message_sum": 24,
                                           "fused_message_edge_lnmod": 12, "edge_gather": 6,
                                           "edge_aggregate": 4}
    ref = chip_smoke.flow_reference(0, "cpu", n_frames=2, n_res=16, hidden=32, layers=1,
                                    steps=(("euler", 2), ("dopri5", 1)))
    assert set(ref) == {"euler", "dopri5"}
    for kind in chip_smoke.FLOW_KINDS:
        _, state, step = chip_smoke.build_flow_trainer("cpu", 0, kind, hidden=32, layers=1, k=8,
                                                       compute_dtype=torch.bfloat16)
        times, metrics, _ = chip_smoke.run_train(state, step, x1, extras, 0, 2, {})
        assert state.step == 2 and ("score" in metrics) == (kind == "sbcfm")
        chip_smoke.flow_train_reference(0, kind, "cpu", hidden=32, layers=1)
    user = chip_smoke.run_flow_user_path(0, "cpu", n_res=(20, 24), n_frames=2, batch=2,
                                         train_steps=2, steps=2, members=2)
    assert user["draws"] == 4 and len(user["losses"]) == 2
    print("flows rehearsed")
""")

DISTILL_PARALLEL_SCRIPT = BLOCKER + textwrap.dedent("""
    # distillation and parallelism, tiny: distillation steps and their card-vs-CPU
    # reference, the user path (the trained VQ-VAE's features of 2 frames, one
    # round 8 -> 4, cli.test on the student and the teacher); the trainers in and
    # out of a process group of one rank (gloo here), the seq-mode checks and
    # the dryrun twin on that rank
    for name in ("gen.distill", "cli.distill", "train.mesh", "parallel.sequence",
                 "parallel.dryrun"):
        assert "codlad_tpu_torch." + name in names, name
    assert chip_smoke.distill_launches() == {
        "fused_message_sum": 18, "fused_message_edge_lnmod": 9, "fused_message_sum_bwd": 6,
        "fused_message_edge_lnmod_bwd": 3}
    _, state, teacher, step, _ = chip_smoke.build_distill_trainer("cpu", 0, hidden=32,
                                                                  layers=1, k=8)
    times, metrics, _ = chip_smoke.run_train(
        state, lambda st, x, e, s: step(st, teacher, x, e, s), x1, extras, 0, 2, {})
    assert state.step == 2
    chip_smoke.distill_reference(0, device="cpu", hidden=32, layers=1)
    user = chip_smoke.run_distill_user_path(0, "cpu", n_frames=2, batch=2, round_steps=2,
                                            members=1, start_steps=8)
    assert user["config"]["distill_tmap"] == [0, 250, 500, 750], user["config"]
    assert user["held_start"] > 0 and user["held_end"] > 0
    small = dict(n_frames=4, n_res=16, batch=2, steps=2, s1_res=(20, 24), s1_frames=2,
                 s1_batch=2, enc=1, dec=1)
    plain = chip_smoke.run_parallel_trainers(0, "cpu", **small)
    chip_smoke.init_world_of_one("cpu")
    try:
        assert chip_smoke.run_parallel_trainers(0, "cpu", **small) == plain
        seq = chip_smoke.seq_mode_checks(0, "cpu", n_frames=2, n_res=32, hidden=32, layers=1,
                                         k=16, train_frames=2)
        assert seq["forward_err"] == 0.0
        from codlad_tpu_torch.parallel.dryrun import dryrun_multichip
        assert set(dryrun_multichip("cpu")) == {"dp", "dp_x_sp_train", "seq_forward",
                                                "stage1_dp"}
        assert set(chip_smoke.ddp_step_times(0, "cpu", n_frames=2, n_res=16, rounds=1,
                                             hidden=32, layers=1, k=8)) == {"plain", "mesh"}
    finally:
        chip_smoke.leave_world()
    print("distill and parallel rehearsed")
""")


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


@pytest.mark.parametrize("script,done", [
    (STAGE1_SCRIPT, "Stage-1 phases rehearsed"), (TRAINED_SCRIPT, "later phases rehearsed")],
    ids=["stage1", "trained_stage2_and_variants"])
def test_later_phases_run_without_jax(script, done):
    """chip_smoke's Stage-1 phases, and its trained Stage-2, whole-trainer,
    guided and Stage-1-variant phases, tiny, under the same import blocker."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert done in proc.stdout


def test_flows_phase_parts_run_without_jax():
    """chip_smoke's flows phase, tiny, under the same import blocker: the
    new modules import, the native library loads, and each part runs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", FLOWS_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "flows rehearsed" in proc.stdout


def test_distill_and_parallel_phases_run_without_jax():
    """chip_smoke's distill and parallel phases, tiny, under the same import
    blocker: the new modules import and each part runs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", DISTILL_PARALLEL_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "distill and parallel rehearsed" in proc.stdout


def test_module_launches_counts_only_its_module():
    """chip_smoke.ModuleLaunches attributes to a submodule exactly the
    launches of its forward and of its backward's nodes, with another
    module's forward and backward nodes around and between them (a stand-in
    autograd Function bumps the K10 / K11 counters)."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke
    from codlad_tpu_torch.kernels import tp_kernels as TK

    class Bump(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, name):
            TK.LAUNCHES[name] += 1
            ctx.kernel = name
            return x * 2

        @staticmethod
        def backward(ctx, g):
            TK.LAUNCHES["fused_tp_bwd" if ctx.kernel == "fused_tp" else "fused_tp"] += 1
            return g * 2, None

    class Sub(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))

        def forward(self, b):
            y = b["x"] * self.w
            for _ in range(3):
                y = Bump.apply(y, "fused_tp")
            return y, y.sum()

    class Top(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.sub, self.v = Sub(), torch.nn.Parameter(torch.ones(3))

        def forward(self, b):
            a = b["x"] * self.v
            for _ in range(5):
                a = Bump.apply(a, "fused_tp_bwd")
            y, s = self.sub(b)
            return (Bump.apply(a + y, "fused_tp_bwd") * y).sum() + s

    top = Top()
    TK.reset_launches()
    with chip_smoke.ModuleLaunches(top.sub) as counter:
        for _ in range(2):
            params = dict(top.named_parameters())
            loss = torch.func.functional_call(top, params, ({"x": torch.randn(3)},))
            torch.autograd.grad(loss, list(params.values()))
    assert counter.counts == {"fused_tp": 6, "fused_tp_bwd": 6}
    assert TK.LAUNCHES == {"fused_tp": 18, "fused_tp_bwd": 18}
    assert not top.sub._forward_hooks and not top.sub._forward_pre_hooks
    TK.reset_launches()


def test_float64_witness_narrows_nothing():
    """chip_smoke's float64 CPU step (the referee of variant_reference)
    computes every floating tensor of the forward and the backward from
    float64 operands in float64: no op narrows a float64 input to float32
    or bf16, for GenZProt, the angle VQ-VAE and the fgvae VAE (1 + 1
    layers, one frame of 12 residues)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    sys.path.insert(0, REPO)
    import chip_smoke
    from codlad_tpu_torch.train import steps as S

    narrowed = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            if any(t.dtype == torch.float64 for t in ins):
                narrowed.extend(str(func) for t in tree_flatten(out)[0]
                                if isinstance(t, torch.Tensor)
                                and t.dtype in (torch.float32, torch.bfloat16))
            return out

    def spied(fn):
        def run(*a, **k):
            with Spy():
                return fn(*a, **k)
        return run

    fc, grads = S.functional_call, S._grads
    S.functional_call, S._grads = spied(fc), spied(grads)
    try:
        layers = ["-enc_nconv", "1", "-dec_nconv", "1"]
        eps = torch.randn((1, chip_smoke.stage1_batch(7, "cpu", 1, 12)["res_type"].shape[1], 36),
                          generator=torch.Generator().manual_seed(0))
        for extra in (["-vqdim", "3", "-train_section", "ivae"],
                      ["-vqdim", "3", "-codebook_size", "64", "-predict_angle"],
                      ["-vqdim", "36", "-train_section", "fgvae"]):
            loss, g, _, skipped = chip_smoke._variant_step("cpu", 0, extra + layers, 1, 12, eps,
                                                           torch.float64)
            assert not narrowed, (extra, sorted(set(narrowed)))
            assert skipped == 0.0 and all(v.dtype == torch.float64 for v in g.values())
    finally:
        S.functional_call, S._grads = fc, grads
