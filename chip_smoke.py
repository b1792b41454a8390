#!/usr/bin/env python3
"""Smoke run of the PyTorch port (codlad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its seconds:
  1. build   -- compile csrc/*.cu with plain nvcc (one process per source);
  2. kernels -- K1 (fused_message_sum) and K2 (fused_message_edge_lnmod) at
                the bench shape (B96 L128 K64 H128), bf16 and f32, against
                their plain PyTorch versions on the same inputs, timed with
                CUDA events beside their bound; then the backwards K3 and K4
                and the dropout kernel K5 (forward and backward), against
                torch.autograd of the plain versions on the same inputs and
                cotangent, K5's mask bit for bit against the plain generator;
                the same checks at the L = 48 bucket (B96 L48 K48: a block
                owns a partial tile of residues); then the Stage-1 kernels
                at the Stage-1 bench shape (4 synthetic frames of 132
                residues, L 192, 2688 atoms, 65536 directed atom edges a
                frame), f32 and bf16: K8 (edge_gather) bit for bit, K9
                (edge_aggregate) and K10 (fused_tp, the three layer
                signatures on the atom edges and on the cross graph's
                [B, L, 14, *] operands) within their tolerances, each timed
                beside its bound, its plain version and the nearest PyTorch
                call; K11 (fused_tp_bwd: dx, dsh, dw) at K10's six shapes
                against autograd of the plain K10 (float64 for f32), timed
                beside its bound, the plain backward and the dense form's
                backward in cuBLAS; the K8/K9 backwards (each the other
                kernel) against autograd of their plain versions;
  3. slice   -- the Stage-2 inference path at full width: a synthetic CG
                batch of 96 frames x 128 residues, 100 respaced ancestral
                steps of the 3+3-layer bf16 denoiser, VQ snap, IC decode
                and xyz14 in f32, with the kernels' launch counts read
                around it (the decoder's graph ops are K8/K9);
  4. timing  -- one more 100-step sample_and_decode, timed; one draw at the
                L = 48 bucket (96 x 48, K = 48);
  5. reference -- a small batch through the same path in f32 on the card
                and with the plain versions on the CPU, same weights and
                noise (kNN indices, one denoise call, 10 sampling steps,
                decode);
  6. train   -- the Stage-2 training path: 20 steps of make_latent_step at
                B96 L128 K64 H128, 3+3 layers, bf16, dropout 0.6, with the
                launches of every step counted (6 K1, 3 K5, 6 K3, 3 K5
                backward), median ms/step and peak memory, the last 3
                steps under torch.profiler (the device's busy share and
                the kernels by device time); then 2 steps at dropout 0
                (6 K1, 3 K2, 6 K3, 3 K4 a step);
  7. train entry -- `python -m codlad_tpu_torch.cli.train_latent` (its
                main) for 5 bf16 steps on a synthetic 96 x 128 feature set;
                finite logged losses, a `last` checkpoint that restores;
  8. train reference -- one f32 step at dropout 0.6 on a small batch on the
                card and on the CPU, same weights, t, noise and dropout seed:
                loss, grad norm, every parameter's grad, updated params
                and EMA;
  9. recon   -- the Stage-1 reconstruction path (`--experiment recon`) at
                the production VQ-VAE config (results/convergence/vqvae:
                embed 36, vqdim 3, ns 12, nv 4, 3 encoder and 4 decoder
                layers, cutoffs 9 and 21 Å, f32, a 512-code codebook) with
                random weights from --seed, on the Stage-1 bench batch:
                encode, VQ snap, decode, xyz14, metrics; launches of K8, K9
                and K10 per encoder forward and per decode asserted; wall
                time, the encoder's share, peak memory; a small batch card
                against CPU (latents, VQ codes with near-ties allowed,
                decode); the bf16 encoder forward timed at the bench batch;
 10. recon trained -- the trained VQ-VAE converted from the study's
                checkpoint (weights/convergence_vqvae.npz) on four frames of
                its val protein prot_0030, against the JAX outputs stored
                beside it (weights/convergence_vqvae_fixture.npz): codes,
                per-frame rmsd_aligned;
 11. recon entry -- `python -m codlad_tpu_torch.cli.test --experiment
                recon` (its main) on a shard directory the port writes,
                with the trained weights; summary_stats.json.
 12. train_stage1 -- the Stage-1 trainer's step (make_vqvae_step) at the
                Stage-1 bench batch and the trained run's config (3 + 4
                layers, 512 codes), random weights from --seed, bf16 feature
                path: 10 steps, launches of K8-K11 asserted every step,
                the loss finite and no step skipped, median ms/step, the
                first step, peak memory, the last step under
                torch.profiler; then 3 steps in f32;
 13. train_stage1_reference -- one f32 step on a small batch (2 x 40) on
                the card and on the CPU: loss, every parameter's grad, the
                VQ state;
 14. train_stage1_entry -- the chain through its entry points on two
                synthetic proteins: cli.train_vqvae (-bf16, 2 epochs, then
                -resume), cli.extract_features, 2 steps of cli.train_latent
                on those features, cli.test --experiment recon --vae_ckpt.

Sampling weights are the port's init from --seed with the adaLN heads (zero
at init) drawn small and random, so that every layer reaches the output;
the training phases start from the plain init, as the trainer does. The line
before the last is the card's name and power limit from nvidia-smi; the
last line is {"ok": true, "device": {...}}; the line before that one the
kernels' JSON. Exits non-zero, printing no result, without a CUDA device or
when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, L, K, H = 96, 128, 64, 128   # bench shape (bench.py)
STEPS = "ddim100"                # 100 respaced steps of a 1000-step process
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
TOL = {"float32": (2e-4, 2e-4),   # atol, rtol as tests/test_kernels.py:77
       "bfloat16": (2e-2, 2e-2)}  # ~2.5 bf16 ulps: one-ulp rounding flips of gelu(pre)
# Backward grads. f32 (against the float64 plain versions): |d| <= 2e-4 +
# 2e-4 * |ref| + 2e-6 * max|ref|; the last term is f32 rounding of the
# per-row terms that a weight grad sums over 786k edge rows (~4e-7 of the
# largest element measured for K4's dW_e), which no per-element tolerance
# can absorb where the sum is near zero. bf16 (against the bf16 plain
# versions): |d| <= c * max|ref|, c per output. The grads that leave in
# bf16 or sum bf16-rounded products (dA, dE, dGn, dW_e, dW2, db2, dW3)
# differ by about one bf16 ulp of their largest element, 2^-8 to 2^-7 of
# max|ref|: c = 2e-2, ~3 ulps. db3, dsh, dsc and dgate are f32 sums of the
# same terms on both sides, which differ in order only: c = 2e-4, 20x
# below one bf16 rounding (2^-9), so that a kernel rounding them fails.
GRAD_SCALE_TOL_F32 = 2e-6
GRAD_TOL_BF16 = dict(dict.fromkeys(("A", "E", "Gn", "W_e", "W2", "b2", "W3"), 2e-2),
                     **dict.fromkeys(("b3", "sh", "sc", "g"), 2e-4))
P_DROP = 0.6                     # the trainer's default dropout
KERNELS = {  # name -> (TPU kernel it replaces, CUDA source)
    "fused_message_sum": ("codlad_tpu/kernels/mpnn_kernels.py:395", "message_chain.cu"),
    "fused_message_edge_lnmod": ("codlad_tpu/kernels/mpnn_kernels.py:519",
                                 "message_chain.cu"),
    "fused_message_sum_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:810",
                              "message_chain_bwd.cu"),
    "fused_message_edge_lnmod_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:854",
                                     "message_chain_bwd.cu"),
    "fused_message_edge_lnmod_drop": ("codlad_tpu/kernels/mpnn_kernels.py:1137",
                                      "message_chain.cu"),
    "fused_message_edge_lnmod_drop_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:1098",
                                          "message_chain_bwd.cu"),
    "edge_gather": ("codlad_tpu/kernels/edge_kernels.py:119", "edge_ops.cu"),
    "edge_aggregate": ("codlad_tpu/kernels/edge_kernels.py:140", "edge_ops.cu"),
    "fused_tp": ("codlad_tpu/kernels/tp_kernels.py:152", "fused_tp.cu"),
    "fused_tp_bwd": ("codlad_tpu/kernels/tp_kernels.py:193", "fused_tp_bwd.cu"),
}
WEIGHTS = Path(__file__).resolve().parent / "weights" / "convergence_vqvae.npz"
FIXTURE = WEIGHTS.with_name("convergence_vqvae_fixture.npz")
K48 = (B, 48, 48)               # the L = 48 length bucket: K = min(64, L) = 48
STAGE1 = (4, 132)               # bench.py:309-327: synthetic_examples(4, 132), quantize_spec
# K9 in bf16 (kernel vs plain, both f32 sums in different orders, then cast
# and divided in bf16): a sum that lands on the other side of a rounding
# boundary is one bf16 ulp (<= 2^-7 of the value) apart, and the division
# rounds once more: |d| <= 2^-6 |ref| + 1e-4 max|ref|, the last term for
# sums that cancel to near zero (f32 order error ~1e-7 of the summed terms).
AGG_TOL_BF16 = (2.0 ** -6, 1e-4)
# K10 in bf16: the plain version rounds TR to bf16 before w * TR, the kernel
# (as the Pallas kernel) keeps it in f32, so each of a column's ~14 products
# differs by up to half a bf16 ulp and the output is rounded once more:
# |d| <= 2e-2 max|ref|, ~3 bf16 ulps of the largest output.
TP_TOL_BF16 = 2e-2
ENC_LAYERS, DEC_LAYERS = 3, 4   # results/convergence/vqvae/modelparams.json
CODEBOOK = 512
CODE_MARGIN = 1e-4              # near-tie of the two nearest codes, squared distance
FLOOR = {"rmsd_aligned": 0.6615, "ged": 0.0165, "clash": 0.0041}  # FLOOR_TABLE.md recon


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def open_gates(model, gen, std=0.02):
    """Draw the zero-initialised adaLN heads N(0, std^2) so the trunk is not
    gated shut (as after training)."""
    import torch
    heads = [layer.Dense_0 for layer in [*model.enc_layers, *model.dec_layers]]
    heads.append(model.w_out.Dense_0)
    with torch.no_grad():
        for lin in heads:
            for p in lin.parameters():
                p.normal_(0.0, std, generator=gen)


def build_pipeline(device, seed, hidden=H, layers=3, k=K, codebook_size=4096,
                   respacing=STEPS, compute_dtype=None):
    """The port's sampling pipeline at the production configuration."""
    import torch
    from codlad_tpu_torch.eval.harness import SamplingPipeline
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.models.vae import VAE

    gen = torch.Generator().manual_seed(seed)
    denoiser = MPNNDenoiser(gen, hidden_dim=hidden, edge_features=hidden,
                            num_encoder_layers=layers, num_decoder_layers=layers,
                            k_neighbors=k)
    open_gates(denoiser, gen)
    codebook = torch.randn((codebook_size, 3), generator=gen)
    return SamplingPipeline(
        denoiser=denoiser.to(device).eval(),
        process=create_diffusion(respacing, diffusion_steps=1000),
        vae=VAE(gen, encoder=False).to(device).eval(), codebook=codebook.to(device),
        norm_mean=[0.0, 0.0, 0.0], norm_std=[1.0, 1.0, 1.0],
        compute_dtype=compute_dtype)


def run_slice(pipe, batch, generator):
    """Drive the main path once and read the kernels' launch counts around
    it: {latents, ic, xyz14, seconds, launches}."""
    import torch
    from codlad_tpu_torch import kernels

    dev = batch["res_type"].device
    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    lat = pipe.sample_latents(extras, generator=generator)
    ic, xyz = pipe.decode(batch, lat)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"latents": lat, "ic": ic, "xyz14": xyz, "seconds": seconds,
            "launches": kernels.launch_counts()}


def check_launches(got, expect, where):
    """Every kernel launched as `expect` says (0 where it says nothing)."""
    for name, n in got.items():
        if n != expect.get(name, 0):  # expect > 0: a kernel never launched fails too
            raise RuntimeError(f"{name} launched {n} times on {where}, "
                               f"expected {expect.get(name, 0)}")


def check_slice(out, n_frames, n_res):
    import torch
    shapes = {"latents": (n_frames, n_res, 3), "ic": (n_frames, n_res, 13, 3),
              "xyz14": (n_frames, n_res, 14, 3)}
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape:
            raise RuntimeError(f"{key} has shape {tuple(v.shape)}, expected {shape}")
        if not torch.isfinite(v).all():
            raise RuntimeError(f"{key} is not finite")


def kernel_inputs(dtype, seed, device, dims=(B, L, K)):
    """Full-width K1/K2 operands in the layout the main path gives them."""
    import torch
    b, l, k = dims
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(device)
    return dict(
        A=r(b, l, H).to(dtype), E=r(b, l, k, H).to(dtype), Gn=r(b, l, H).to(dtype),
        idx=torch.randint(0, l, (b, l, k), generator=g, dtype=torch.int32).to(device),
        mask=(torch.rand(b, l, k, generator=g) > 0.2).float().to(device),
        W_e=r(H, H, sc=H ** -0.5).to(dtype), W2=r(H, H, sc=H ** -0.5).to(dtype),
        b2=r(H, sc=0.1), W3=r(H, H, sc=H ** -0.5).to(dtype), b3=r(H, sc=0.1),
        sh=r(b, H, sc=0.3), sc=r(b, H, sc=0.3), g=r(b, H))


def kernel_calls(x):
    """{name: (kernel call, plain call, bytes moved, matmul flops)}."""
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    es = x["E"].element_size()
    b, l, k, _ = x["E"].shape
    n_edge = b * l * k
    chain_in = (b * l * H + n_edge * H + b * l * H) * es + n_edge * 4 + 3 * H * H * es + 2 * H * 4
    s_args = [x[k] for k in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")]
    e_args = [x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3",
                             "sh", "sc", "g")]
    return {
        "fused_message_sum": (
            lambda: MK.fused_message_sum(*s_args, 30.0),
            lambda: MK.ref_message_sum(*s_args, 30.0),
            chain_in + n_edge * 4 + b * l * H * 4,
            2 * 2 * n_edge * H * H + 2 * b * l * H * H),
        "fused_message_edge_lnmod": (
            lambda: MK.fused_message_edge_lnmod(*e_args),
            lambda: MK.ref_message_edge_lnmod(*e_args),
            chain_in + 3 * b * H * 4 + n_edge * H * es,
            3 * 2 * n_edge * H * H),
    }


def time_calls(*fns, reps=10):
    """Median ms of each call, timed with CUDA events, the order of the
    calls reversed every other round."""
    import torch
    times = [[] for _ in fns]
    for i in range(reps):
        order = list(enumerate(fns))
        for j, fn in (order if i % 2 == 0 else order[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[j].append(e0.elapsed_time(e1))
    return tuple(statistics.median(t) for t in times)


def check_kernels(device, seed, dims=(B, L, K)):
    """Every kernel against its plain version, both dtypes; returns the
    bf16 (main-path dtype) record of each kernel."""
    import torch
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        x = kernel_inputs(dtype, seed, device, dims)
        atol, rtol = TOL[dname]
        for name, (kern, plain, nbytes, flops) in kernel_calls(x).items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            ms, plain_ms = time_calls(kern, plain)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_OPS[dname] * 1e3
            log(f"kernel {name} {dname} {dims_tag(dims)}: max|d|={err:.3g} (atol {atol:g} + "
                f"rtol {rtol:g}*|ref|) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP)")
            if not ok:
                raise RuntimeError(f"{name} ({dname}) disagrees with its plain version")
            if dtype == torch.bfloat16:
                records[name] = record(name, err, ms, plain_ms, t_bytes, t_ops)
        del x
    return records


def record(name, err, ms, plain_ms, t_bytes, t_ops, library_ms=None):
    """One row of the `kernels` JSON line (launches filled in later)."""
    replaces, source = KERNELS[name]
    return {"name": name, "route": "cuda", "source": f"codlad_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


_DIFF = ("A", "E", "Gn", "W_e", "W2", "b2", "W3", "b3")
_SUM_KEYS = ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")
_EDGE_KEYS = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sh", "sc", "g")


def as_f64(x):
    """x with every floating tensor in float64."""
    return {k: v.double() if v.is_floating_point() else v for k, v in x.items()}


def grads_of(fn, x, keys, diff, ct):
    """(output, {name: grad}, plain backward closure) of fn at x's values."""
    import torch
    leaves = {k: x[k].detach().clone().requires_grad_(k in diff) for k in keys}
    out = fn(*(leaves[k] for k in keys))
    ins = [leaves[k] for k in diff]
    gs = torch.autograd.grad(out, ins, ct, retain_graph=True)
    return out.detach(), dict(zip(diff, gs)), (
        lambda: torch.autograd.grad(out, ins, ct, retain_graph=True))


def compare_grads(label, got, want, dname):
    """Every grad against its plain version; returns the largest |d|.
    Logs max|d| / max|ref| of each before failing on any."""
    worst, bad = 0.0, []
    for n, w in want.items():
        d = (got[n].float() - w.float()).abs()
        ref = w.float().abs()
        if dname == "float32":
            bound = (TOL["float32"][0] + TOL["float32"][1] * ref
                     + GRAD_SCALE_TOL_F32 * ref.max())
            limit = "atol 2e-4 + rtol 2e-4 + 2e-6 max|ref|"
        else:
            bound = GRAD_TOL_BF16[n] * ref.max()
            limit = f"{GRAD_TOL_BF16[n]:g} max|ref|"
        ok = bool((d <= bound).all())
        err = d.max().item()
        worst = max(worst, err)
        log(f"  {label} {dname} d{n}: max|d|={err:.3g} max|ref|={ref.max().item():.3g} "
            f"ratio {err / max(ref.max().item(), 1e-30):.3g} ({limit}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"d{n}")
    if bad:
        raise RuntimeError(f"{label} ({dname}) {bad} disagree with plain autograd")
    return worst


def dims_tag(dims):
    return "B{} L{} K{}".format(*dims)


def bwd_bytes_flops(es, edge, dims=(B, L, K)):
    """Bytes (each input read once, each output written once) and matmul
    flops of K3 (edge=False) or K4 / K5's backward (edge=True)."""
    b, l, k = dims
    n_edge, n_node = b * l * k, b * l
    nbytes = ((2 * n_node * H + n_edge * H) * es + n_edge * 4 + 3 * H * H * es + 2 * H * 4
              + n_node * H * 4 + n_edge * H * es + n_node * H * 4      # dA, dE, dGn
              + 3 * H * H * 4 + 2 * H * 4)                              # weight grads
    if edge:   # + sc, g, dout; dsh, dsc, dgate
        nbytes += 2 * b * H * 4 + n_edge * H * es + 3 * b * H * 4
        flops = 9 * 2 * n_edge * H * H
    else:      # + mask, dout f32 [B, L, H]
        nbytes += n_edge * 4 + n_node * H * 4
        flops = 6 * 2 * n_edge * H * H + 2 * 2 * n_node * H * H
    return nbytes, flops


def check_bwd_kernels(device, seed, dims=(B, L, K)):
    """K3, K4 and K5 (forward and backward) at the training shape, f32 and
    bf16, against autograd of the plain versions; K5's mask bit for bit
    against the plain generator. Returns the bf16 record of each.

    The f32 kernels are held against the plain versions run in float64 on
    the same (upcast) inputs and cotangent: in f32, autograd's weight grads
    are cuBLAS products over 786k edge rows that accumulate in f32 and carry
    ~1e-6 of the summed terms' scale themselves (~2e-3 for K4's dW_e), more
    than the f32 tolerance. The plain f32 versions remain the timing
    yardstick. bf16 kernels are held against the bf16 plain versions."""
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    records = {}
    b, l, k = dims
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        x = kernel_inputs(dtype, seed, device, dims)
        g = torch.Generator().manual_seed(seed + 7)
        ct_sum = torch.randn(b, l, H, generator=g).to(device)
        ct_edge = torch.randn(b, l, k, H, generator=g).to(device).to(dtype)
        seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, dtype=torch.int32).to(device)
        edge_diff = _DIFF + ("sh", "sc", "g")
        args = lambda keys: [x[k] for k in keys]

        f32 = dtype == torch.float32
        xr = as_f64(x) if f32 else x  # the correctness reference's inputs
        ref_ct = (lambda c: c.double()) if f32 else (lambda c: c)

        def reference(fn, keys, diff, ct):
            return grads_of(fn, xr, keys, diff, ref_ct(ct))

        # K3 through K1's autograd wrapper
        _, gk, _ = grads_of(lambda *a: MK.fused_message_sum(*a, 30.0), x, _SUM_KEYS, _DIFF,
                            ct_sum)
        _, gp, _ = reference(lambda *a: MK.ref_message_sum(*a, 30.0), _SUM_KEYS, _DIFF,
                             ct_sum)
        err = compare_grads(f"K3 {dims_tag(dims)}", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(lambda *a: MK.ref_message_sum(*a, 30.0), x, _SUM_KEYS,
                                   _DIFF, ct_sum)
        sum_args = args(("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3"))
        dout = ct_sum / 30.0
        ms, plain_ms = time_calls(lambda: MK.message_sum_bwd(*sum_args, dout), plain_bwd)
        recs = {"fused_message_sum_bwd": (err, ms, plain_ms,
                                          *bwd_bytes_flops(es, False, dims))}
        del gk, plain_bwd

        # K4 through K2's autograd wrapper
        _, gk, _ = grads_of(MK.fused_message_edge_lnmod, x, _EDGE_KEYS, edge_diff, ct_edge)
        _, gp, _ = reference(MK.ref_message_edge_lnmod, _EDGE_KEYS, edge_diff, ct_edge)
        err = compare_grads(f"K4 {dims_tag(dims)}", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(MK.ref_message_edge_lnmod, x, _EDGE_KEYS, edge_diff,
                                   ct_edge)
        bwd_args = args(("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sc", "g"))
        ms, plain_ms = time_calls(lambda: MK.message_edge_lnmod_bwd(*bwd_args, ct_edge),
                                 plain_bwd)
        recs["fused_message_edge_lnmod_bwd"] = (err, ms, plain_ms,
                                                *bwd_bytes_flops(es, True, dims))
        del gk, plain_bwd

        # K5: the seeded forward's mask, its rate, its output and its backward
        out, mask = MK.edge_lnmod_pdrop_debug(*args(_EDGE_KEYS), seeds, P_DROP)
        want_mask = MK.keep_scales(seeds, (l, k, H), P_DROP)
        same = torch.equal(mask, want_mask)
        frac = (mask > 0).double().mean().item()
        want = MK.plain_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP)
        d = (out.float() - want.float()).abs()
        atol, rtol = TOL[dname]
        fwd_ok = bool((d <= atol + rtol * want.float().abs()).all())
        log(f"  K5 {dname}: mask {'equals' if same else 'DIFFERS FROM'} the plain generator's "
            f"({mask.numel()} elements); keep fraction {frac:.6f} (1-p = {1 - P_DROP:g} "
            f"+/- 0.002); forward max|d|={d.max().item():.3g} {'ok' if fwd_ok else 'FAIL'}")
        if not (same and abs(frac - (1 - P_DROP)) <= 0.002 and fwd_ok):
            raise RuntimeError(f"K5 ({dname}) forward or mask disagrees with its plain version")
        del out, mask, want
        fwd_err = d.max().item()
        ms, plain_ms = time_calls(
            lambda: MK.fused_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP),
            lambda: MK.plain_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP))
        k2_bytes, k2_flops = kernel_calls(x)["fused_message_edge_lnmod"][2:]
        recs["fused_message_edge_lnmod_drop"] = (fwd_err, ms, plain_ms, k2_bytes + b * 4,
                                                 k2_flops)
        pd = lambda *a: MK.fused_message_edge_lnmod_pdrop(*a, seeds, P_DROP)
        plain_pd = lambda *a: MK.plain_message_edge_lnmod_pdrop(*a, seeds, P_DROP)
        _, gk, _ = grads_of(pd, x, _EDGE_KEYS, edge_diff, ct_edge)
        _, gp, _ = reference(plain_pd, _EDGE_KEYS, edge_diff, ct_edge)
        err = compare_grads(f"K5 seeded {dims_tag(dims)}", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(plain_pd, x, _EDGE_KEYS, edge_diff, ct_edge)
        ms, plain_ms = time_calls(
            lambda: MK.message_edge_lnmod_bwd(*bwd_args, ct_edge, seeds=seeds, p=P_DROP),
            plain_bwd)
        nbytes, flops = bwd_bytes_flops(es, True, dims)
        recs["fused_message_edge_lnmod_drop_bwd"] = (err, ms, plain_ms, nbytes + b * 4, flops)
        del gk, plain_bwd

        # K5 with the keep operand: forward and grads
        keep = want_mask.to(dtype)
        kd = lambda *a: MK.fused_message_edge_lnmod_drop(*a, keep)
        out_k, gk, _ = grads_of(kd, x, _EDGE_KEYS, edge_diff, ct_edge)
        out_p, gp, _ = reference(lambda *a: MK.ref_message_edge_lnmod(*a, keep=keep),
                                 _EDGE_KEYS, edge_diff, ct_edge)
        d = (out_k.float() - out_p.float()).abs()
        if not bool((d <= atol + rtol * out_p.float().abs()).all()):
            raise RuntimeError(f"K5 keep variant ({dname}) forward disagrees")
        compare_grads(f"K5 keep {dims_tag(dims)}", gk, gp, dname)
        del gk, gp, out_k, out_p, keep, want_mask, x, xr
        torch.cuda.empty_cache()

        for name, (err, ms, plain_ms, nbytes, flops) in recs.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_OPS[dname] * 1e3
            log(f"kernel {name} {dname} {dims_tag(dims)}: max|d|={err:.3g}; kernel {ms:.4f} ms, "
                f"plain "
                f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
            if dtype == torch.bfloat16:
                records[name] = record(name, err, ms, plain_ms, t_bytes, t_ops)
    return records


def reference_check(seed, device="cuda"):
    """The path in f32 on the card (kernels) against the CPU (plain
    versions): same weights and inputs, B2 L32.

    * condition: each residue's K neighbours must be the same set (their
      order may differ where distances tie up to rounding: consecutive
      C-alpha are all 3.8 A apart, and every layer is invariant to the
      order of a residue's neighbours);
    * one denoise call on the CPU's condition: atol 1e-4 + rtol 1e-4;
    * 10 ancestral steps with the same x_T and per-step noise, each side on
      its own condition: 1e-4 of the latents' scale. Each residue is its own
      first neighbour, and the featurizer's quaternion of that near-identity
      rotation turns f32 rounding differences (~1e-7) into ~3e-4 between the
      devices; the sampler carries that into x_0 (and x_0 reaches hundreds
      with these random weights: sqrt(1/acp) ~ 70 at the first step);
    * the CPU's latents decoded on both sides (so that a code flip at a VQ
      boundary can neither hide nor fake a decode difference): atol 1e-3."""
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device

    pipes = {"cpu": build_pipeline("cpu", seed, respacing="ddim10"),
             device: build_pipeline(device, seed, respacing="ddim10")}
    nb = synthetic_cg_batch(2, 32, seed=seed + 1)
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((2, 32, 3), generator=g)
    zs = [torch.randn((2, 32, 3), generator=g)
          for _ in range(pipes["cpu"].process.num_timesteps)]
    batches, conds, dens, lats = {}, {}, {}, {}
    for dev, pipe in pipes.items():
        batch = batches[dev] = to_device(nb, dev)
        extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
                  "mask": batch["res_mask"]}
        with torch.no_grad():
            conds[dev] = pipe.denoiser.compute_condition(
                extras["res_type"], extras["cg_xyz"], extras["mask"])
            cond = {k: v.to(dev) for k, v in conds["cpu"].items()}
            steps = torch.full((2,), 500, device=dev)
            dens[dev] = pipe.denoiser.denoise(noise.to(dev), steps, cond).cpu()
        lats[dev] = pipe.sample_latents(extras, noise=noise.to(dev),
                                        noises=[z.to(dev) for z in zs]).cpu()
    idx_same = torch.equal(conds["cpu"]["idx"].sort(dim=-1).values,
                           conds[device]["idx"].cpu().sort(dim=-1).values)
    ref = dens["cpu"]
    d_den = (dens[device] - ref).abs()
    den_ok = bool((d_den <= 1e-4 + 1e-4 * ref.abs()).all())
    scale = lats["cpu"].abs().max().item()
    d_lat = (lats[device] - lats["cpu"]).abs().max().item()
    xyz = {dev: pipe.decode(batches[dev], lats["cpu"].to(dev))[1].cpu()
           for dev, pipe in pipes.items()}
    d_xyz = (xyz[device] - xyz["cpu"]).abs().max().item()
    log(f"reference (card f32 kernels vs CPU plain versions): kNN neighbour sets "
        f"{'equal' if idx_same else 'DIFFER'}; denoise max|d|={d_den.max().item():.3g} "
        f"(atol 1e-4 + rtol 1e-4); latents max|d|={d_lat:.3g} (tol {1e-4 * scale:.3g} = "
        f"1e-4 * max|latent| {scale:.3g}); xyz14 max|d|={d_xyz:.3g} (atol 1e-3)")
    if not (idx_same and den_ok and d_lat <= 1e-4 * scale and d_xyz <= 1e-3):
        raise RuntimeError("the card's path disagrees with the CPU reference")


TRAIN_STEPS = 20
TRACED_STEPS = 3                 # the last ones, under torch.profiler


def train_launches(n_enc, n_dec, dropout):
    """Kernel launches of one training step: K1 for every node update, the
    encoder's edge update through K2 (K5 with dropout), and their backwards."""
    edge = "fused_message_edge_lnmod" + ("_drop" if dropout > 0 else "")
    return {"fused_message_sum": n_enc + n_dec, edge: n_enc,
            "fused_message_sum_bwd": n_enc + n_dec, edge + "_bwd": n_enc}


def build_trainer(device, seed, hidden=H, layers=3, k=K, dropout=P_DROP,
                  compute_dtype=None, lr=3e-4, warmup=0, gates=False):
    """(model, TrainState, train_step) of the production denoiser. gates=True
    draws the adaLN heads small and random (open_gates), so that every
    parameter gets a gradient at the first step."""
    import torch
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
    from codlad_tpu_torch.train.steps import make_latent_step

    gen = torch.Generator().manual_seed(seed)
    model = MPNNDenoiser(gen, hidden_dim=hidden, edge_features=hidden,
                         num_encoder_layers=layers, num_decoder_layers=layers,
                         k_neighbors=k, dropout=dropout)
    if gates:
        open_gates(model, gen)
    model.to(device)
    state = TrainState(dict(model.named_parameters()), warmup_linear_schedule(lr, warmup),
                       grad_clip=1.0)
    step, _ = make_latent_step(model, create_diffusion(None, diffusion_steps=1000),
                               dropout=dropout > 0, compute_dtype=compute_dtype)
    return model, state, step


def train_batch(n_frames, n_res, seed, device, jitter=0.0):
    """(x1, extras) of a synthetic training batch: N(0, 1) latents and random
    C-alpha walks; `jitter` (Å, N(0, jitter^2)) breaks the exact 3.8 Å ties
    of consecutive C-alpha, so that the kNN order is the same on every device."""
    import numpy as np
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch
    nb = synthetic_cg_batch(n_frames, n_res, seed=seed)
    rng = np.random.default_rng(seed)
    cg = nb["cg_xyz_og"][:, 1:-1]
    cg = (cg + jitter * rng.standard_normal(cg.shape)).astype(np.float32)
    x1 = rng.standard_normal(nb["res_type"].shape + (3,)).astype(np.float32)
    extras = {"res_type": nb["res_type"], "cg_xyz": cg, "mask": nb["res_mask"]}
    return (torch.as_tensor(x1, device=device),
            {k: torch.as_tensor(v, device=device) for k, v in extras.items()})


CHAIN_KERNELS = ("chain_kernel", "chain_bwd_kernel", "wgrad_kernel", "sum_partials")  # csrc
STAGE1_KERNELS = ("gather_kernel", "aggregate_kernel", "fused_tp_kernel",          # csrc
                  "fused_tp_bwd_kernel")


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_summary(prof, wall_ms, n_steps, top=12, mine=CHAIN_KERNELS,
                  label="message-chain kernels", unit="step"):
    """Log the device's busy share of the traced wall time (the union of
    kernel intervals) and the kernels by device time a `unit`, the kernels
    named in `mine` (default the message chains, K1-K5) summed apart."""
    import torch
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        spans.append((e.time_range.start, e.time_range.end))
    if not by_name:
        log("  trace: no device events; device time not measured")
        return
    busy = busy_us(spans) / (wall_ms * 1e3)
    total = sum(us for us, _ in by_name.values())
    chain = sum(us for k, (us, _) in by_name.items() if any(c in k for c in mine))
    log(f"  trace of {n_steps} {unit}s ({wall_ms / n_steps:.2f} ms/{unit} wall): device busy "
        f"{busy:.3f} (idle {1 - busy:.3f}); kernels {total / 1e3 / n_steps:.2f} ms/{unit}, "
        f"{label} {chain / 1e3 / n_steps:.2f} ms ({chain / total:.3f}), other "
        f"{(total - chain) / 1e3 / n_steps:.2f} ms; "
        f"{sum(n for _, n in by_name.values()) // n_steps} launches a {unit}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3 / n_steps:9.3f} ms/{unit} {n // n_steps:5d}x  {name[:100]}")


def run_train(state, step, x1, extras, seed, n_steps, expect, traced=0):
    """n_steps training steps with every step's launches counted and held
    to `expect` (zero for any kernel it does not name); the last `traced`
    of them run under torch.profiler, whose summary is logged. Returns the
    ms of the untraced steps, the last metrics and the launch totals."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from codlad_tpu_torch import kernels
    cuda = x1.device.type == "cuda"
    p0 = {k: v.clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    totals, times = dict.fromkeys(kernels.launch_counts(), 0), []
    with contextlib.ExitStack() as stack:
        for i in range(n_steps):
            if i == n_steps - traced:
                prof = stack.enter_context(profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            if cuda:
                torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step(state, x1, extras, seed + i)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = kernels.launch_counts()
            want = dict(dict.fromkeys(got, 0), **expect)
            if got != want:
                raise RuntimeError(f"training step {i} launched {got}, expected {want}")
            totals = {k: totals[k] + n for k, n in got.items()}
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise RuntimeError(f"training step {i}: loss {loss}, grad_norm {gnorm}")
    if traced:
        trace_summary(prof, sum(times[n_steps - traced:]), traced)
    moved = lambda a, b: any(not torch.equal(a[k], b[k]) for k in a)
    if not (moved(state.params, p0) and moved(state.ema_params, e0)):
        raise RuntimeError("the params or the EMA did not move")
    return times[:n_steps - traced], metrics, totals


def run_train_cli(seed, device="cuda", n_frames=B, n_res=L, batch=B, steps=5):
    """The trainer's entry point on a synthetic feature set in a temporary
    directory: finite logged losses, and a `last` checkpoint that restores
    into a fresh state. Returns the logged rows."""
    import json
    import tempfile
    import numpy as np
    import torch
    from codlad_tpu_torch.cli import train_latent as CLI
    from codlad_tpu_torch.data.cg_batch import write_synthetic_features
    from codlad_tpu_torch.data.norm import save_stats
    from codlad_tpu_torch.train.checkpoints import CheckpointManager
    from codlad_tpu_torch.train.state import TrainState

    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_features(f"{tmp}/feat", n_frames, n_res, seed=seed)
        save_stats(f"{tmp}/stats", "SMOKE", np.zeros(3, np.float32), np.ones(3, np.float32))
        state = CLI.main(["--feature_dir", f"{tmp}/feat", "--exp", f"{tmp}/exp",
                          "--stats_name", "SMOKE", "--stats_dir", f"{tmp}/stats",
                          "--batch_size", str(batch), "--max_steps", str(steps),
                          "--log_step", "1", "--save_step", str(steps), "--warmup", "100",
                          "--seed", str(seed), "--bf16", "--device", str(device)])
        with open(f"{tmp}/exp/metrics.jsonl") as f:
            rows = [json.loads(r) for r in f]
        if [r["step"] for r in rows] != list(range(1, steps + 1)) or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
            raise RuntimeError(f"trainer log: {rows}")
        fresh = TrainState({k: torch.zeros_like(v) for k, v in state.params.items()},
                           lambda s: 0.0)
        CheckpointManager(f"{tmp}/exp").restore(fresh, "last")
        if fresh.step != steps or any(not torch.equal(fresh.params[k], v)
                                      for k, v in state.params.items()):
            raise RuntimeError("the trainer's `last` checkpoint does not restore its state")
    return rows


# Weights of the 2.45M whose clipped grads have opposite signs on the two
# devices (12 and 13 at seeds 0 and 1 on an NVIDIA H100 80GB HBM3, 700 W):
# ~4x room.
MAX_SIGN_FLIPS = 50


def train_reference(seed, device="cuda", hidden=H, layers=3):
    """One f32 training step at dropout 0.6 on a B2 L32 K16 batch, on the
    card (kernels) and on the CPU (plain versions), from the same weights,
    t, noise and dropout seed. Tolerances, as tests/test_torch_train_step.py
    holds the port against JAX: the featurizer's self-edge quaternions
    carry ~3e-4 of rounding noise on either device, so loss, mse and grad
    norm rtol 1e-3 and each parameter's grad 1e-3 * max|grad|. Updated
    params: AdamW's first step moves a weight by -lr * u(g), u(g) = g /
    (|g| + 1e-8) of the clipped grad g, which turns a tiny grad difference
    into a large one where g is near zero; so each weight is held at atol
    2e-5 + rtol 1e-5 plus lr times the bound on |u(g_card) - u(g_cpu)| that
    the two sides' own clipped grads give: eps |dg| / (min|g| + eps)^2 where
    the signs agree. Where they do not (a grad within its rounding of zero,
    or zero on one side only), u may differ by up to 2, so those weights are
    counted and at most MAX_SIGN_FLIPS of them may take the bound |u(g_card)|
    + |u(g_cpu)|. EMA: ema = 0.9999 p0 + 1e-4 p, from the same p0 on both
    sides, so |d ema| <= 1e-4 |d p| + two f32 roundings of ema (2^-22 |ema|).
    The kNN order must be the same on both (the dropout mask belongs to the
    (l, k) slot), so the trace is jittered off the exact 3.8 Å ties."""
    import torch
    lr, eps, clip, decay = 1e-3, 1e-8, 1.0, 0.9999
    x1, extras = train_batch(2, 32, seed + 2, "cpu", jitter=0.1)
    g = torch.Generator().manual_seed(seed + 3)
    t = torch.randint(0, 1000, (2,), generator=g)
    noise = torch.randn((2, 32, 3), generator=g)
    runs = {}
    for dev in ("cpu", device):
        model, state, step = build_trainer(dev, seed, hidden=hidden, layers=layers, k=16,
                                           lr=lr, gates=True)
        ex = {k: v.to(dev) for k, v in extras.items()}
        with torch.no_grad():
            idx = model.compute_condition(ex["res_type"], ex["cg_xyz"], ex["mask"])["idx"]
        state, m = step(state, x1.to(dev), ex, seed, t=t.to(dev), noise=noise.to(dev))
        runs[str(dev)] = (idx.cpu(), {k: float(m[k]) for k in ("loss", "mse", "grad_norm")},
                          {k: v.cpu() for k, v in m["grads"].items()},
                          {k: v.cpu() for k, v in state.params.items()},
                          {k: v.cpu() for k, v in state.ema_params.items()})
    (idx_c, m_c, g_c, p_c, e_c), (idx_d, m_d, g_d, p_d, e_d) = runs["cpu"], runs[str(device)]
    if not torch.equal(idx_c, idx_d):
        raise RuntimeError("the kNN order differs between the devices")
    worst_g = max(((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                  for k, v in g_c.items())

    def clipped(g, norm):
        return {k: v.double() * min(1.0, clip / norm) for k, v in g.items()}

    gc, gd = clipped(g_c, m_c["grad_norm"]), clipped(g_d, m_d["grad_norm"])
    u = lambda g: g.abs() / (g.abs() + eps)
    excess, worst_p, worst_e, flips, n_weights = 0.0, 0.0, 0.0, 0, 0
    for k, v in p_c.items():
        a, b = gc[k], gd[k]
        same = a * b > 0
        flips += int((~same & ((a != 0) | (b != 0))).sum())
        n_weights += v.numel()
        du = torch.where(same, eps * (a - b).abs() / (torch.minimum(a.abs(), b.abs())
                                                       + eps) ** 2, u(a) + u(b))
        d = (p_d[k] - v).abs().double()
        excess = max(excess, (d - (2e-5 + 1e-5 * v.abs().double() + lr * du)).max().item())
        worst_p = max(worst_p, d.max().item())
        de = (e_d[k] - e_c[k]).abs().double()
        worst_e = max(worst_e, (de - ((1 - decay) * d + 2.0 ** -22 * e_c[k].abs().double()))
                      .max().item())
    rel = {k: abs(m_d[k] - m_c[k]) / abs(m_c[k]) for k in m_c}
    log(f"train reference (card f32 kernels vs CPU plain, dropout {P_DROP}): loss "
        f"{m_d['loss']:.6g} vs {m_c['loss']:.6g}, grad_norm {m_d['grad_norm']:.6g} vs "
        f"{m_c['grad_norm']:.6g}; rel |d| {', '.join(f'{k} {v:.3g}' for k, v in rel.items())} "
        f"(rtol 1e-3); worst max|dgrad|/max|grad| over {len(g_c)} params {worst_g:.3g} "
        f"(tol 1e-3); updated params max|d| {worst_p:.3g}, largest excess over the bound "
        f"{excess:.3g} (atol 2e-5 + rtol 1e-5 + lr * |du| from the grads; must be <= 0); "
        f"clipped grads of opposite sign {flips} of {n_weights} weights (at most "
        f"{MAX_SIGN_FLIPS}); EMA largest excess over 1e-4 |dp| + 2^-22 |ema| {worst_e:.3g} "
        f"(must be <= 0)")
    if not (all(v <= 1e-3 for v in rel.values()) and worst_g <= 1e-3 and excess <= 0.0
            and flips <= MAX_SIGN_FLIPS and worst_e <= 0.0):
        raise RuntimeError("the card's training step disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# Stage 1: the recon path and its kernels K8, K9, K10


def stage1_batch(seed, device, n_frames=STAGE1[0], n_res=STAGE1[1]):
    """The Stage-1 bench batch: synthetic all-atom frames, featurized and
    padded to the bucket lattice (bench.py's stage-1 shape by default)."""
    from codlad_tpu_torch.data.batch import collate, quantize_spec, spec_for
    from codlad_tpu_torch.data.cg_batch import to_device
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    ex = synthetic_examples(n_frames, n_res, seed=seed)
    return to_device(collate(ex, quantize_spec(spec_for(ex))), device)


def _bits(t):
    """t's bit patterns (for bit-for-bit equality)."""
    import torch
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def check_stage1_kernels(batch, seed):
    """K8, K9 and K10 against their plain versions at the recon path's
    shapes on `batch` (the atom graph, directed), f32 and bf16; timed with
    CUDA events beside the bound, the plain version and the nearest PyTorch
    call. Returns the f32 (the recon path's dtype) record of each, at the
    largest call of the encoder: K8 the layer-2 atom feature gather (F 36),
    K9 the layer-2 atom mean (F 48), K10 the layer-2 atom TP."""
    import torch
    from codlad_tpu_torch.kernels import edge_kernels as EK
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

    dev = batch["res_type"].device
    nb, nl = batch["res_type"].shape
    na = nl * 14
    edges, emask = make_directed_batched(batch["atom_edges"], batch["atom_edges_mask"])
    src = edges[..., 0].to(torch.int32).contiguous()
    dst = edges[..., 1].to(torch.int32).contiguous()
    maskf = emask.to(torch.float32)
    ne = src.shape[1]
    csr = EK.build_csr(src, maskf, na)
    n_valid = csr[1].numel()
    flat_src, flat_dst = EK._flat_index(src, na), EK._flat_index(dst, na)
    log(f"  stage-1 shape: B{nb} L{nl} atoms {na}, {ne} directed atom edges a frame "
        f"({n_valid} valid in all)")
    g = torch.Generator().manual_seed(seed + 11)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    ladder = irrep_ladder(12, 4)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8

        def report(name, label, err, ok, limit, kern, plain, library, nbytes, ops):
            ms, plain_ms, lib_ms = time_calls(kern, plain, library)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dname] * 1e3
            log(f"kernel {name} {dname} {label}: max|d|={err:.3g} ({limit}) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G ops)")
            if not ok:
                raise RuntimeError(f"{name} ({dname}, {label}) disagrees with its plain version")
            return record(name, err, ms, plain_ms, t_bytes, t_ops, lib_ms)

        # K8: the geometry gather [xyz | z] (F 4) and the layer-2 features (F 36)
        for F in (4, 36):
            nodes = rnd(nb, na, F).to(dtype)
            kern = lambda: EK.edge_gather(dst, maskf, nodes)
            plain = lambda: EK.ref_gather(dst, maskf, nodes)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            same = torch.equal(_bits(got), _bits(want))
            err = (got.float() - want.float()).abs().max().item()
            rec = report("edge_gather", f"F{F}", err, same, "bit for bit", kern, plain,
                         lambda: nodes.reshape(-1, F).index_select(0, flat_dst),
                         nb * ne * 8 + nb * na * F * es + nb * ne * F * es, nb * ne * F)
            if F == 36 and dtype == torch.float32:
                records["edge_gather"] = rec

        # K9: the layer-0 atom mean (F 12) and the layer-2 one (F 48)
        for F in (12, 48):
            msgs = rnd(nb, ne, F).to(dtype)
            kern = lambda: EK.edge_aggregate(src, maskf, msgs, na, "mean", csr)
            plain = lambda: EK.ref_aggregate(src, maskf, msgs, na, "mean")
            got, want = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            d, ref = (got.float() - want.float()).abs(), want.float().abs()
            if dtype == torch.float32:
                bound, limit = TOL[dname][0] + TOL[dname][1] * ref, "atol 2e-4 + rtol 2e-4"
            else:
                bound = AGG_TOL_BF16[0] * ref + AGG_TOL_BF16[1] * ref.max()
                limit = "2^-6 |ref| + 1e-4 max|ref|"
            ok = bool((d <= bound).all()) and torch.equal(_bits(got), _bits(again))
            lib = lambda: torch.zeros((nb * na, F), dtype=dtype, device=dev).index_add_(
                0, flat_src, msgs.reshape(-1, F))
            rec = report("edge_aggregate", f"F{F} mean (run-to-run bit-equal)", d.max().item(),
                         ok, limit, kern, plain, lib,
                         nb * ne * 8 + (nb * na + 1 + n_valid) * 4 + n_valid * F * es
                         + nb * na * F * es, 2 * n_valid * F)
            if F == 48 and dtype == torch.float32:
                records["edge_aggregate"] = rec
            del msgs, got, want, again

        # K10: the three layer signatures on the atom edges, and on the cross
        # graph's [B, L, 14, *] operands
        for layer in range(3):
            tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS),
                                 tuple(ladder[layer + 1]))
            din, numel, R = ladder[layer].dim, tb["numel"], tb["R"]
            dout = tb["SUMR"].shape[1]
            nnz = TK.sparse_tables(tb)["nnz"]
            for where, lead in (("edges", (nb, ne)), ("cross", (nb, nl, 14))):
                x = rnd(*lead, din).to(dtype)
                sh = sh_l2(rnd(*lead, 3)).to(dtype)
                w = (rnd(*lead, numel) * din ** -0.5).to(dtype)
                kern = lambda: TK.fused_tp(x, sh, w, tb)
                plain = lambda: TK.ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
                got, want = kern(), plain()
                torch.cuda.synchronize()
                d, ref = (got.float() - want.float()).abs(), want.float().abs()
                if dtype == torch.float32:
                    ok, limit = bool((d <= 2e-4 + 2e-4 * ref).all()), "atol 2e-4 + rtol 2e-4"
                else:
                    ok = bool((d <= TP_TOL_BF16 * ref.max()).all())
                    limit = f"{TP_TOL_BF16:g} max|ref| (max|ref| {ref.max().item():.3g})"
                tabs = [torch.as_tensor(tb[k], device=dev).to(dtype)
                        for k in ("CBIG_R", "EXPW", "SUMR")]
                t = torch.cat([x * sh[..., b:b + 1] for b in range(9)], dim=-1)
                lib = lambda: ((w @ tabs[1]) * (t @ tabs[0])) @ tabs[2]
                m = x.numel() // din
                rec = report("fused_tp", f"layer {layer} {where} {tuple(lead)}", d.max().item(),
                             ok, limit, kern, plain, lib, m * (din + 9 + numel + dout) * es,
                             m * (9 * din + 2 * nnz + 2 * R))
                if layer == 2 and where == "edges" and dtype == torch.float32:
                    records["fused_tp"] = rec
                del x, sh, w, got, want, t
        torch.cuda.empty_cache()
    return records


def encoder_launches(n_layers=ENC_LAYERS):
    """K8/K9/K10 launches of one encoder forward: 4 geometry gathers, per
    layer 2 atom gathers, 1 atom mean, the atom TP and the CG->atom TP, and
    but for the last layer 2 CG gathers, 1 CG mean, the CG TP and the
    atom->CG TP."""
    n = n_layers
    return {"edge_gather": 4 + 2 * n + 2 * (n - 1), "edge_aggregate": n + (n - 1),
            "fused_tp": 2 * n + 2 * (n - 1)}


def decoder_launches(n_conv=DEC_LAYERS):
    """K8/K9 launches of one IC decode: 2 geometry gathers, and a gather and
    an aggregate per invariant message layer."""
    return {"edge_gather": 2 + n_conv, "edge_aggregate": n_conv}


def build_recon(device, seed, compute_dtype=None):
    """The recon pipeline at the production VQ-VAE config, random weights
    and a random N(0, 1) codebook of CODEBOOK codes from `seed`."""
    import torch
    from codlad_tpu_torch.eval.harness import SamplingPipeline
    from codlad_tpu_torch.models.vae import VAE
    gen = torch.Generator().manual_seed(seed)
    vae = VAE(gen, embed_dim=36, vqdim=3, dec_nconv=DEC_LAYERS, enc_nconv=ENC_LAYERS,
              compute_dtype=compute_dtype or torch.float32)
    codebook = torch.randn((CODEBOOK, 3), generator=gen)
    return SamplingPipeline(denoiser=None, process=None, vae=vae.to(device).eval(),
                            codebook=codebook.to(device), norm_mean=[0.0, 0.0, 0.0],
                            norm_std=[1.0, 1.0, 1.0])


def run_recon(pipe, batch):
    """Encode -> normalise -> snap -> decode -> metrics once, with the
    kernels' launches read around the encoder and around the rest:
    {latents, ic, xyz14, codes, metrics, seconds, encoder_seconds,
    decode_seconds (snap, decode, xyz14), enc_launches, dec_launches}."""
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.eval.harness import evaluate_structures
    cuda = batch["res_type"].device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    h = pipe.encode_latents(batch)
    sync()
    t_enc = time.perf_counter() - t0
    enc = kernels.launch_counts()
    kernels.reset_launches()
    ic, xyz, codes = pipe.decode(batch, pipe.normalise(h), return_codes=True)
    sync()
    t_dec = time.perf_counter() - t0 - t_enc
    metrics = {k: float(v) for k, v in evaluate_structures(batch, ic, xyz).items()}
    sync()
    return {"latents": h, "ic": ic, "xyz14": xyz, "codes": codes, "metrics": metrics,
            "seconds": time.perf_counter() - t0, "encoder_seconds": t_enc,
            "decode_seconds": t_dec, "enc_launches": enc,
            "dec_launches": kernels.launch_counts()}


def check_recon(out, batch):
    """Shapes, finite values and the launches of every kernel."""
    import torch
    nb, nl = batch["res_type"].shape
    shapes = {"latents": (nb, nl, 3), "ic": (nb, nl, 13, 3), "xyz14": (nb, nl, 14, 3)}
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape or not torch.isfinite(v).all():
            raise RuntimeError(f"recon {key}: shape {tuple(v.shape)} (expected {shape}) "
                               f"or not finite")
    if not all(math.isfinite(v) for v in out["metrics"].values()):
        raise RuntimeError(f"recon metrics not finite: {out['metrics']}")
    cuda = batch["res_type"].device.type == "cuda"   # on the CPU no kernel launches
    for part, want in (("enc_launches", encoder_launches()),
                       ("dec_launches", decoder_launches())):
        check_launches(out[part], want if cuda else {}, f"the recon path ({part})")


def code_gaps(codebook, z):
    """Squared distance from each z [..., D] to its second-nearest code minus
    that to its nearest: how far the snap is from a tie."""
    import torch
    d = ((z.reshape(-1, 1, z.shape[-1]) - codebook[None]) ** 2).sum(-1)
    two = torch.topk(d, 2, dim=-1, largest=False).values
    return (two[:, 1] - two[:, 0]).reshape(z.shape[:-1])


def recon_reference(seed, device="cuda"):
    """The recon path in f32 on the card (kernels) against the CPU (plain
    versions), same weights, on a small batch (2 frames of 40 residues):
    latents atol 1e-4 + rtol 1e-4 (sums in another order); VQ codes equal
    except where the CPU latent's two nearest codes are within CODE_MARGIN
    (squared distance) of a tie, and the flips are counted; the CPU's
    latents decoded on both sides (so that a flip can neither hide nor fake
    a decode difference) to xyz14 within atol 1e-3 Å."""
    import torch
    batches = {dev: stage1_batch(seed + 5, dev, 2, 40) for dev in ("cpu", device)}
    pipes = {dev: build_recon(dev, seed) for dev in ("cpu", device)}
    outs = {dev: run_recon(pipes[dev], batches[dev]) for dev in ("cpu", device)}
    cpu, card = outs["cpu"], outs[device]
    ref = cpu["latents"]
    d_lat = (card["latents"].cpu() - ref).abs()
    lat_ok = bool((d_lat <= 1e-4 + 1e-4 * ref.abs()).all())
    mask = batches["cpu"]["res_mask"].bool()
    flip = (card["codes"].cpu() != cpu["codes"]) & mask
    gaps = code_gaps(pipes["cpu"].codebook, ref)
    bad_flips = int((flip & (gaps > CODE_MARGIN)).sum())
    xyz = {dev: pipes[dev].decode(batches[dev], ref.to(dev))[1].cpu() for dev in pipes}
    d_xyz = (xyz[device] - xyz["cpu"]).abs().max().item()
    log(f"recon reference (card f32 kernels vs CPU plain versions, 2 x 40): latents "
        f"max|d|={d_lat.max().item():.3g} (atol 1e-4 + rtol 1e-4); VQ codes flipped "
        f"{int(flip.sum())} of {int(mask.sum())} residues, {bad_flips} of them not near-tied "
        f"(gap > {CODE_MARGIN:g}); xyz14 from the CPU latents max|d|={d_xyz:.3g} (atol 1e-3)")
    if not (lat_ok and bad_flips == 0 and d_xyz <= 1e-3):
        raise RuntimeError("the card's recon path disagrees with the CPU reference")


def recon_trained(device="cuda"):
    """The converted trained VQ-VAE on the fixture frames against the JAX
    outputs stored with them: VQ codes equal wherever the JAX latent's two
    nearest codes differ by more than CODE_MARGIN; per-frame rmsd_aligned
    within 1e-3 Å of JAX's. Returns the port's batch-mean metrics."""
    import numpy as np
    import torch
    from codlad_tpu_torch.cli.test import load_vae
    from codlad_tpu_torch.convert.from_flax import read_flax_npz
    from codlad_tpu_torch.eval.harness import SamplingPipeline, evaluate_structures
    vae, codebook, _ = load_vae(str(WEIGHTS), device)
    mean, std = read_flax_npz(str(WEIGHTS))["stats"]
    pipe = SamplingPipeline(denoiser=None, process=None, vae=vae, codebook=codebook,
                            norm_mean=mean, norm_std=std)
    with np.load(FIXTURE) as fx:
        want = {k: fx[k] for k in fx.files}
    batch = {k[len("batch/"):]: torch.as_tensor(v, device=device) for k, v in want.items()
             if k.startswith("batch/")}
    out = run_recon(pipe, batch)
    per_frame = evaluate_structures(batch, out["ic"], out["xyz14"], per_frame=True)
    rmsd = per_frame["rmsd_aligned"].cpu().numpy()
    d_rmsd = np.abs(rmsd - want["metric/rmsd_aligned"]).max()
    jlat = torch.as_tensor(want["latents"], device=device)
    tied = code_gaps(codebook, jlat) <= CODE_MARGIN
    mask = batch["res_mask"].bool()
    differ = (out["codes"] != torch.as_tensor(want["codes"], device=device)) & mask
    d_lat = (out["latents"] - jlat).abs().max().item()
    m = out["metrics"]
    log(f"recon trained (weights/convergence_vqvae.npz, prot_0030 x {rmsd.size} frames): "
        f"latents max|d| vs JAX {d_lat:.3g}; codes differ at {int(differ.sum())} of "
        f"{int(mask.sum())} residues ({int((differ & ~tied).sum())} not near-tied, gap > "
        f"{CODE_MARGIN:g}); per-frame rmsd_aligned {np.round(rmsd, 5).tolist()} vs JAX "
        f"{np.round(want['metric/rmsd_aligned'], 5).tolist()}, max|d| {d_rmsd:.3g} Å (tol "
        f"1e-3); mean rmsd_aligned {m['rmsd_aligned']:.4f}, ged {m['ged']:.4f}, clash "
        f"{m['clash']:.4f} (FLOOR_TABLE.md recon over its 4 proteins, for context: "
        f"{FLOOR['rmsd_aligned']}, {FLOOR['ged']}, {FLOOR['clash']})")
    if int((differ & ~tied).sum()) or not d_rmsd <= 1e-3:
        raise RuntimeError("the trained VQ-VAE on the card disagrees with the JAX outputs")
    return m


def run_recon_cli(seed, device="cuda", batch_size=4):
    """The recon CLI's main on two proteins of 3 frames the port writes as
    shards, with the trained weights: summary_stats.json with finite
    per-protein and global metrics."""
    import json
    import os
    import tempfile
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/shards")
        for i, n_res in enumerate((58, 75)):
            save_protein_shard(f"{tmp}/shards/prot_{i:04d}.npz",
                               synthetic_examples(3, n_res, seed=seed + i, prot_idx=i,
                                                  structured=True))
        CLI.main(["--experiment", "recon", "--vae_weights", str(WEIGHTS), "--data_dir",
                  f"{tmp}/shards", "--out_dir", f"{tmp}/eval", "--batch_size",
                  str(batch_size), "--device", str(device)])
        with open(f"{tmp}/eval/summary_stats.json") as f:
            summary = json.load(f)
    glob = summary["__global__"]
    if set(summary) != {"prot_0000.npz", "prot_0001.npz", "__global__", "__global_stats__"} \
            or not all(math.isfinite(v) for v in glob.values()):
        raise RuntimeError(f"recon CLI summary: {summary}")
    return glob


# ---------------------------------------------------------------------------
# Stage 1 training: K11 and the K8/K9 backwards, the trainer's step, its CLI


def tp_bwd_cost(m, din, numel, dout, R, nnz, es, dsh=9):
    """(bytes, operations) of K11 over m rows: x, sh, w and dct read once,
    dx, dsh and dw written once; 4 nnz + 5 R + 5 dsh din operations a row
    (TR, dTR and dwR, the two transposed products, dx and dsh)."""
    return (m * ((din + dsh + numel + dout) + (din + dsh + numel)) * es,
            m * (4 * nnz + 5 * R + 5 * dsh * din))


def check_stage1_bwd_kernels(batch, seed):
    """K11 against autograd of the plain K10 (float64 for the f32 kernel,
    bf16 for the bf16 one) at K10's six shapes of the Stage-1 bench batch,
    dx, dsh and dw, timed beside its bound, the plain backward and the dense
    form's backward as cuBLAS products; then the K8 / K9 backwards (K9 over
    the dst CSR for the layer-2 atom feature gather, F 36; K8 of the
    cotangent over the valid degree for the layer-2 atom mean, F 48)
    against autograd of their plain versions. Returns the bf16 (the
    trainer's dtype) record of K11 at the layer-2 atom edges."""
    import torch
    from codlad_tpu_torch.kernels import edge_kernels as EK
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

    dev = batch["res_type"].device
    nb, nl = batch["res_type"].shape
    na = nl * 14
    edges, emask = make_directed_batched(batch["atom_edges"], batch["atom_edges_mask"])
    src = edges[..., 0].to(torch.int32).contiguous()
    dst = edges[..., 1].to(torch.int32).contiguous()
    maskf = emask.to(torch.float32)
    ne = src.shape[1]
    g = torch.Generator().manual_seed(seed + 13)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    ladder = irrep_ladder(12, 4)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        ref_dt = torch.float64 if dtype == torch.float32 else dtype
        for layer in range(3):
            tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS),
                                 tuple(ladder[layer + 1]))
            din, numel, R = ladder[layer].dim, tb["numel"], tb["R"]
            dout = tb["SUMR"].shape[1]
            nnz = TK.sparse_tables(tb)["nnz"]
            for where, lead in (("edges", (nb, ne)), ("cross", (nb, nl, 14))):
                x = rnd(*lead, din).to(dtype)
                sh = sh_l2(rnd(*lead, 3)).to(dtype)
                w = (rnd(*lead, numel) * din ** -0.5).to(dtype)
                ct = rnd(*lead, dout).to(dtype)
                got = TK.fused_tp_bwd(x, sh, w, ct, tb)
                leaves = [t.to(ref_dt).requires_grad_(True) for t in (x, sh, w)]
                out = TK.ref_fused_tp(*leaves, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
                want = torch.autograd.grad(out, leaves, ct.to(ref_dt))
                torch.cuda.synchronize()
                errs, ok = {}, True
                for name, a, b in zip(("dx", "dsh", "dw"), got, want):
                    d, ref = (a.double() - b.double()).abs(), b.double().abs()
                    if dtype == torch.float32:
                        bound = TOL[dname][0] + TOL[dname][1] * ref + GRAD_SCALE_TOL_F32 * ref.max()
                    else:
                        bound = TP_TOL_BF16 * ref.max()
                    ok = ok and bool((d <= bound).all())
                    errs[name] = (d.max().item(), ref.max().item())
                del out, want, leaves
                limit = ("atol 2e-4 + rtol 2e-4 + 2e-6 max|ref|, ref in float64"
                         if dtype == torch.float32 else f"{TP_TOL_BF16:g} max|ref|")
                pl = [t.detach().requires_grad_(True) for t in (x, sh, w)]
                pout = TK.ref_fused_tp(*pl, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
                plain = lambda: torch.autograd.grad(pout, pl, ct, retain_graph=True)
                tabs = [torch.as_tensor(tb[k], device=dev).to(dtype)
                        for k in ("CBIG_R", "EXPW", "SUMR")]

                def library():   # the dense form's backward as cuBLAS products
                    t = torch.cat([x * sh[..., b:b + 1] for b in range(9)], dim=-1)
                    dprod = ct @ tabs[2].T
                    dw = (dprod * (t @ tabs[0])) @ tabs[1].T
                    db = ((dprod * (w @ tabs[1])) @ tabs[0].T).unflatten(-1, (9, din))
                    return (db * sh[..., :, None]).sum(-2), (db * x[..., None, :]).sum(-1), dw

                kern = lambda: TK.fused_tp_bwd(x, sh, w, ct, tb)
                ms, plain_ms, lib_ms = time_calls(kern, plain, library)
                m = x.numel() // din
                nbytes, ops = tp_bwd_cost(m, din, numel, dout, R, nnz, es)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS[dname] * 1e3
                err = max(e for e, _ in errs.values())
                log(f"kernel fused_tp_bwd {dname} layer {layer} {where} {tuple(lead)}: "
                    f"max|d|/max|ref| "
                    f"{', '.join(f'{n} {e:.3g}/{r:.3g}' for n, (e, r) in errs.items())} "
                    f"({limit}) {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                    f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
                    f"{ops / 1e9:.3f} G ops)")
                if not ok:
                    raise RuntimeError(f"fused_tp_bwd ({dname}, layer {layer} {where}) "
                                       "disagrees with plain autograd")
                if layer == 2 and where == "edges" and dtype == torch.bfloat16:
                    records["fused_tp_bwd"] = record("fused_tp_bwd", err, ms, plain_ms,
                                                     t_bytes, t_ops, lib_ms)
                del x, sh, w, ct, got, pl, pout
                torch.cuda.empty_cache()

        # K8's backward (K9 over the dst CSR) and K9's (K8 of ct / degree)
        csr_dst = EK.build_csr(dst, maskf, na)
        csr_src = EK.build_csr(src, maskf, na)
        nodes = rnd(nb, na, 36).to(dtype).requires_grad_(True)
        ct_e = rnd(nb, ne, 36).to(dtype)
        (got,) = torch.autograd.grad(EK.edge_gather(dst, maskf, nodes, csr_dst), nodes, ct_e)
        rl = nodes.detach().to(torch.float64 if dtype == torch.float32 else torch.float32)
        rl.requires_grad_(True)
        (want,) = torch.autograd.grad(EK.ref_gather(dst, maskf, rl), rl, ct_e.to(rl.dtype))
        d, ref = (got.double() - want.double()).abs(), want.double().abs()
        bound = (1e-5 + 1e-5 * ref) if dtype == torch.float32 else (
            2.0 ** -8 * ref + 1e-5 * ref.max())
        ok_g = bool((d <= bound).all())
        msgs = rnd(nb, ne, 48).to(dtype).requires_grad_(True)
        ct_n = rnd(nb, na, 48).to(dtype)
        (got_a,) = torch.autograd.grad(EK.edge_aggregate(src, maskf, msgs, na, "mean", csr_src),
                                       msgs, ct_n)
        rm = msgs.detach().requires_grad_(True)
        (want_a,) = torch.autograd.grad(EK.ref_aggregate(src, maskf, rm, na, "mean"), rm, ct_n)
        torch.cuda.synchronize()
        ok_a = torch.equal(got_a, want_a)
        log(f"kernel backwards {dname}: d nodes of K8 (K9 over the dst CSR, F 36) max|d| "
            f"{d.max().item():.3g} of max|ref| {ref.max().item():.3g} "
            f"({'atol 1e-5 + rtol 1e-5, ref float64' if dtype == torch.float32 else '2^-8 |ref| + 1e-5 max|ref|, ref float32'}) "
            f"{'ok' if ok_g else 'FAIL'}; d msgs of K9 mean (K8 of ct / degree, F 48) "
            f"{'bit for bit' if ok_a else 'DIFFERS'}")
        if not (ok_g and ok_a):
            raise RuntimeError(f"the K8/K9 backwards ({dname}) disagree with plain autograd")
        del nodes, msgs, got, want, got_a, want_a, rl, rm
        torch.cuda.empty_cache()
    return records


STAGE1_TRAIN_STEPS = 10


def stage1_train_launches(n_enc=ENC_LAYERS, n_dec=DEC_LAYERS):
    """K8-K11 launches of one Stage-1 training step: the encoder forward and
    the decode, and their backwards: every gather whose input needs a grad
    (all but the encoder's 4 and the decoder's 2 geometry gathers) costs a
    K9, every aggregate a K8, every K10 a K11."""
    enc, dec = encoder_launches(n_enc), decoder_launches(n_dec)
    grad_gathers = (enc["edge_gather"] - 4) + (dec["edge_gather"] - 2)
    aggregates = enc["edge_aggregate"] + dec["edge_aggregate"]
    return {"edge_gather": enc["edge_gather"] + dec["edge_gather"] + aggregates,
            "edge_aggregate": aggregates + grad_gathers,
            "fused_tp": enc["fused_tp"], "fused_tp_bwd": enc["fused_tp"]}


def build_stage1_trainer(device, seed, compute_dtype=None, n_codes=CODEBOOK,
                         enc=ENC_LAYERS, dec=DEC_LAYERS):
    """(VAE, TrainState, train_step) of the Stage-1 trainer
    (cli/train_vqvae.py `build_trainer`) at the trained config (embed 36,
    vqdim 3), random weights and a vq_init codebook from `seed`."""
    import torch
    from codlad_tpu_torch.cli import train_vqvae
    args = train_vqvae.build_parser().parse_args(
        ["-seed", str(seed), "-vqdim", "3", "-codebook_size", str(n_codes), "-enc_nconv",
         str(enc), "-dec_nconv", str(dec)] + (["-bf16"] if compute_dtype == torch.bfloat16
                                              else []))
    vae, state, step, _, _ = train_vqvae.build_trainer(args, device)
    return vae, state, step


def stage1_weights():
    """LossWeights(zeta=5, omega=3).dynamic(2), as bench.py's Stage-1 step."""
    from codlad_tpu_torch.train.losses import LossWeights
    from codlad_tpu_torch.train.steps import weights_to_array
    return weights_to_array(LossWeights(zeta=5.0, omega=3.0).dynamic(2))


def run_stage1_train(state, step, batch, n_steps, expect, traced=0):
    """n_steps Stage-1 training steps, each step's launches counted and held
    to `expect`, the loss finite and no step skipped; the last `traced`
    steps under torch.profiler (summary logged). Returns (ms of the
    untraced steps, the last metrics, the host-read ms of each step)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from codlad_tpu_torch import kernels
    cuda = batch["res_type"].device.type == "cuda"
    w = stage1_weights()
    p0 = {k: v.clone() for k, v in state.params.items()}
    times, syncs = [], []
    with contextlib.ExitStack() as stack:
        for i in range(n_steps):
            if i == n_steps - traced:
                prof = stack.enter_context(profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            if cuda:
                torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, w)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = kernels.launch_counts()
            want = dict(dict.fromkeys(got, 0), **expect)
            if got != want:
                raise RuntimeError(f"Stage-1 training step {i} launched {got}, expected {want}")
            loss = float(metrics["loss"])
            if not math.isfinite(loss) or float(metrics["skipped"]) != 0.0:
                raise RuntimeError(f"Stage-1 training step {i}: loss {loss}, skipped "
                                   f"{float(metrics['skipped'])}")
            syncs.append(float(metrics["sync_ms"]))
    if traced:
        trace_summary(prof, sum(times[n_steps - traced:]), traced, mine=STAGE1_KERNELS,
                      label="K8-K11")
    if not any(not torch.equal(state.params[k], v) for k, v in p0.items()):
        raise RuntimeError("the Stage-1 params did not move")
    return times[:n_steps - traced], metrics, syncs


def stage1_train_reference(seed, device="cuda"):
    """One f32 Stage-1 training step on the card (kernels) and on the CPU
    (plain versions) from the same weights, VQ state and batch (2 frames of
    40 residues, 3 + 4 layers): loss within rel 1e-5, each parameter's grad
    within 1e-3 max|grad|, the VQ state (codebook, cluster_size, embed_avg)
    within 1e-5 + 1e-5 |ref|, the VQ codes equal."""
    import torch
    runs = {}
    for dev in ("cpu", device):
        _, state, step = build_stage1_trainer(dev, seed)
        batch = stage1_batch(seed + 7, dev, 2, 40)
        state, m = step(state, batch, stage1_weights(), return_grads=True)
        runs[str(dev)] = (float(m["loss"]), {k: v.cpu() for k, v in m["grads"].items()},
                          {k: v.cpu() for k, v in state.vq_state.tensors().items()},
                          float(m["skipped"]))
    (l_c, g_c, v_c, s_c), (l_d, g_d, v_d, s_d) = runs["cpu"], runs[str(device)]
    rel = abs(l_d - l_c) / abs(l_c)
    worst_g = max(((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                  for k, v in g_c.items())
    worst_v = max(((v_d[k] - v).abs() - 1e-5 * v.abs()).max().item() for k, v in v_c.items())
    log(f"train_stage1 reference (card f32 kernels vs CPU plain, 2 x 40): loss {l_d:.7g} vs "
        f"{l_c:.7g} (rel {rel:.3g}, tol 1e-5); worst max|dgrad|/max|grad| over {len(g_c)} "
        f"params {worst_g:.3g} (tol 1e-3); VQ state largest |d| - 1e-5 |ref| {worst_v:.3g} "
        f"(must be <= 1e-5); skipped {s_d:g} / {s_c:g}")
    if not (rel <= 1e-5 and worst_g <= 1e-3 and worst_v <= 1e-5 and s_c == s_d == 0.0):
        raise RuntimeError("the card's Stage-1 training step disagrees with the CPU reference")


def run_stage1_cli(seed, device="cuda", n_res=(58, 75), n_frames=4, batch=2, enc=ENC_LAYERS,
                   dec=DEC_LAYERS, codes=CODEBOOK):
    """The Stage-1 chain through its entry points on two synthetic proteins:
    train_vqvae (-bf16, 2 epochs, then -resume for a third), extract_features
    on its checkpoint, 2 steps of train_latent on those features, and the
    recon CLI on the checkpoint. Returns {name: summary} of each step."""
    import json
    import os
    import tempfile
    from codlad_tpu_torch.cli import extract_features, train_latent, train_vqvae
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/shards")
        for i, n in enumerate(n_res):
            save_protein_shard(f"{tmp}/shards/prot_{i:04d}.npz",
                               synthetic_examples(n_frames, n, seed=seed + i, prot_idx=i,
                                                  structured=True))
        common = ["-data_dir", f"{tmp}/shards", "-logdir", f"{tmp}/vq", "-batch_size",
                  str(batch), "-vqdim", "3", "-codebook_size", str(codes), "-enc_nconv",
                  str(enc), "-dec_nconv", str(dec), "-bf16", "-seed", str(seed),
                  "--device", str(device)]
        t0 = time.perf_counter()
        first = train_vqvae.main(common + ["-nepochs", "2"])
        t1 = time.perf_counter()
        resumed = train_vqvae.main(common + ["-nepochs", "3", "-resume"])
        t2 = time.perf_counter()
        with open(f"{tmp}/vq/train_log.csv") as f:
            rows = f.read().splitlines()[1:]
        epochs = [r.split(",")[0] for r in rows]
        losses = [float(r.split(",")[1]) for r in rows]
        if epochs != ["0", "1", "2"] or not all(math.isfinite(v) for v in losses) or \
                resumed.step != first.step * 3 // 2:
            raise RuntimeError(f"train_vqvae log {rows}, steps {first.step} -> {resumed.step}")
        out["train_vqvae"] = {"epochs": epochs, "train_loss": losses,
                              "steps": resumed.step, "seconds": (t1 - t0, t2 - t1)}
        usage = extract_features.main(["--ckpt", f"{tmp}/vq", "--data_dir", f"{tmp}/shards",
                                       "--out_dir", f"{tmp}/feat", "--stats_name", "S1",
                                       "--stats_dir", f"{tmp}/stats", "--batch_size",
                                       str(batch), "--device", str(device)])
        out["extract_features"] = {"codes_active": int((usage > 0).sum()),
                                   "residues": int(usage.sum())}
        state = train_latent.main(["--feature_dir", f"{tmp}/feat", "--exp", f"{tmp}/latent",
                                   "--stats_name", "S1", "--stats_dir", f"{tmp}/stats",
                                   "--batch_size", str(batch), "--max_steps", "2",
                                   "--log_step", "1", "--save_step", "2", "--bf16",
                                   "--seed", str(seed), "--device", str(device)])
        with open(f"{tmp}/latent/metrics.jsonl") as f:
            lat = [json.loads(r) for r in f]
        if state.step != 2 or not all(math.isfinite(r["loss"]) for r in lat):
            raise RuntimeError(f"train_latent on the extracted features: {lat}")
        out["train_latent"] = {"losses": [r["loss"] for r in lat]}
        summary = CLI.main(["--experiment", "recon", "--vae_ckpt", f"{tmp}/vq", "--data_dir",
                            f"{tmp}/shards", "--out_dir", f"{tmp}/eval", "--batch_size",
                            str(n_frames), "--device", str(device)])
        glob = summary["__global__"]
        if not all(math.isfinite(v) for v in glob.values()):
            raise RuntimeError(f"recon CLI on the trained checkpoint: {glob}")
        out["test_recon"] = glob
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    from codlad_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    seconds, logs = build.timed_build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    log(f"phase build: {seconds:.2f} s")

    t0 = time.perf_counter()
    records = check_kernels(device, args.seed)
    records.update(check_bwd_kernels(device, args.seed))
    check_kernels(device, args.seed, K48)       # logged; the records keep the bench shape
    check_bwd_kernels(device, args.seed, K48)
    s1_batch = stage1_batch(args.seed, device)
    records.update(check_stage1_kernels(s1_batch, args.seed))
    records.update(check_stage1_bwd_kernels(s1_batch, args.seed))
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    batch = to_device(synthetic_cg_batch(B, L, seed=args.seed), device)
    pipe = build_pipeline(device, args.seed, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    log(f"phase setup: {time.perf_counter() - t0:.2f} s (batch {B}x{L}, weights)")

    t0 = time.perf_counter()
    out = run_slice(pipe, batch, gen)
    check_slice(out, B, L)
    steps = pipe.process.num_timesteps
    n_enc = len(pipe.denoiser.enc_layers)
    expect = {"fused_message_sum": steps * (n_enc + len(pipe.denoiser.dec_layers)),
              "fused_message_edge_lnmod": steps * n_enc, **decoder_launches()}
    log(f"phase slice: {time.perf_counter() - t0:.2f} s; launches {out['launches']} "
        f"(expected {expect}); xyz14 {tuple(out['xyz14'].shape)} finite")
    check_launches(out["launches"], expect, "the sampling path")
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[name]["launches"] = out["launches"][name]

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ic, xyz = pipe.sample_and_decode(batch, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(xyz).all():
        raise RuntimeError("timed run produced non-finite xyz14")
    log(f"phase timing: {dt:.3f} s for {steps} denoise steps + decode "
        f"({steps / dt:.2f} steps/s, batch {B}x{L}, bf16 denoiser)")
    b48, l48, k48 = K48
    out = run_slice(pipe, to_device(synthetic_cg_batch(b48, l48, seed=args.seed + 3), device),
                    gen)
    check_slice(out, b48, l48)
    check_launches(out["launches"], expect, "the sampling path at L = 48")
    log(f"  one draw at the L = 48 bucket ({b48}x{l48}, K {k48}): {out['seconds']:.3f} s "
        f"({steps / out['seconds']:.2f} steps/s); launches as expected; xyz14 finite")

    t0 = time.perf_counter()
    reference_check(args.seed)
    log(f"phase reference: {time.perf_counter() - t0:.2f} s")
    del pipe, out

    t0 = time.perf_counter()
    x1, extras = train_batch(B, L, args.seed + 1, device)
    model, state, step = build_trainer(device, args.seed, compute_dtype=torch.bfloat16)
    per_step = train_launches(len(model.enc_layers), len(model.dec_layers), P_DROP)
    torch.cuda.reset_peak_memory_stats()
    times, metrics, totals = run_train(state, step, x1, extras, args.seed, TRAIN_STEPS,
                                       per_step, traced=TRACED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("fused_message_sum_bwd", "fused_message_edge_lnmod_drop",
                 "fused_message_edge_lnmod_drop_bwd"):  # K1's count is the sampling path's
        records[name]["launches"] = totals[name]
    log(f"phase train: {time.perf_counter() - t0:.2f} s; {TRAIN_STEPS} steps B{B} L{L} K{K} "
        f"H{H} bf16 dropout {P_DROP}: median of the {len(times)} untraced "
        f"{statistics.median(times):.2f} ms/step "
        f"(first {times[0]:.1f} ms), {1e3 / statistics.median(times):.2f} steps/s, peak "
        f"memory {peak:.2f} GiB; launches a step {per_step}; last loss "
        f"{float(metrics['loss']):.5g}, grad_norm {float(metrics['grad_norm']):.5g}")
    del model, state, step

    t0 = time.perf_counter()
    model, state, step = build_trainer(device, args.seed, dropout=0.0,
                                       compute_dtype=torch.bfloat16)
    per_step = train_launches(len(model.enc_layers), len(model.dec_layers), 0.0)
    times, metrics, totals = run_train(state, step, x1, extras, args.seed, 2, per_step)
    records["fused_message_edge_lnmod_bwd"]["launches"] = totals["fused_message_edge_lnmod_bwd"]
    log(f"phase train_p0: {time.perf_counter() - t0:.2f} s; 2 steps at dropout 0: "
        f"{statistics.median(times):.2f} ms/step; launches a step {per_step}")
    del model, state, step, x1, extras

    t0 = time.perf_counter()
    rows = run_train_cli(args.seed, device)
    log(f"phase train_entry: {time.perf_counter() - t0:.2f} s; train_latent.main "
        f"--bf16 --batch_size {B} --max_steps {len(rows)}: losses "
        f"{[round(r['loss'], 4) for r in rows]}, last {rows[-1]['steps_per_sec']:.2f} "
        f"steps/s; `last` restores")

    t0 = time.perf_counter()
    train_reference(args.seed, device)
    log(f"phase train_reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    pipe = build_recon(device, args.seed)
    run_recon(pipe, s1_batch)                   # first use: tables to the card
    torch.cuda.reset_peak_memory_stats()
    out = run_recon(pipe, s1_batch)
    check_recon(out, s1_batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("edge_gather", "edge_aggregate", "fused_tp"):
        records[name]["launches"] = out["enc_launches"][name] + out["dec_launches"][name]
    nb, nl = s1_batch["res_type"].shape
    sec = out["seconds"]
    log(f"phase recon: {time.perf_counter() - t0:.2f} s; batch {nb}x{nl} f32: "
        f"{sec * 1e3:.2f} ms a batch: encoder {out['encoder_seconds'] * 1e3:.2f} ms "
        f"({out['encoder_seconds'] / sec:.3f}), snap + decode + xyz14 "
        f"{out['decode_seconds'] * 1e3:.2f} ms ({out['decode_seconds'] / sec:.3f}), metrics "
        f"{(sec - out['encoder_seconds'] - out['decode_seconds']) * 1e3:.2f} ms; peak memory "
        f"{peak:.2f} GiB; "
        f"launches per encoder forward {out['enc_launches']}, per decode "
        f"{out['dec_launches']}; metrics (random weights) "
        f"{ {k: round(v, 4) for k, v in out['metrics'].items()} }")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = run_recon(pipe, s1_batch)
    trace_summary(prof, traced["seconds"] * 1e3, 1, mine=STAGE1_KERNELS,
                  label="K8/K9/K10", unit="batch")
    recon_reference(args.seed, device)
    pipe = build_recon(device, args.seed, compute_dtype=torch.bfloat16)
    pipe.encode_latents(s1_batch)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = pipe.encode_latents(s1_batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    if not torch.isfinite(h).all():
        raise RuntimeError("the bf16 encoder gave non-finite latents")
    log(f"  bf16 encoder forward at {nb}x{nl}: median {statistics.median(times):.2f} ms of 3 "
        f"(f32 {out['encoder_seconds'] * 1e3:.2f} ms)")
    log(f"phase recon total: {time.perf_counter() - t0:.2f} s")
    del pipe, out, s1_batch

    t0 = time.perf_counter()
    recon_trained(device)
    log(f"phase recon_trained: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    glob = run_recon_cli(args.seed, device)
    log(f"phase recon_entry: {time.perf_counter() - t0:.2f} s; cli.test --experiment recon "
        f"on 2 shards: global rmsd_aligned {glob['rmsd_aligned']:.4f}, ged {glob['ged']:.4f}, "
        f"clash {glob['clash']:.4f}; summary_stats.json written")

    t0 = time.perf_counter()
    s1_batch = stage1_batch(args.seed, device)
    per_step = stage1_train_launches()
    for dtype, n_steps, traced in ((torch.bfloat16, STAGE1_TRAIN_STEPS, 1),
                                   (torch.float32, 3, 0)):
        dname = str(dtype).split(".")[-1]
        _, state, step = build_stage1_trainer(device, args.seed, compute_dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        times, metrics, syncs = run_stage1_train(state, step, s1_batch, n_steps, per_step,
                                                 traced=traced)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if dtype == torch.bfloat16:
            records["fused_tp_bwd"]["launches"] = per_step["fused_tp_bwd"] * n_steps
        nb, nl = s1_batch["res_type"].shape
        log(f"  train_stage1 {dname}: {n_steps} steps of make_vqvae_step at {nb}x{nl} (3 + 4 "
            f"layers, 512 codes, LossWeights(zeta=5, omega=3).dynamic(2)): median of the "
            f"{len(times)} untraced {statistics.median(times[1:] or times):.2f} ms/step (first "
            f"{times[0]:.1f} ms), host read of the loss {statistics.median(syncs):.2f} ms a "
            f"step (median), peak memory {peak:.2f} GiB; launches a step {per_step} "
            f"(asserted); last loss {float(metrics['loss']):.5g}, recon "
            f"{float(metrics['recon']):.5g}, vq {float(metrics['vq']):.4g}, perplexity "
            f"{float(metrics['vq_perplexity']):.4g}; skipped 0 at every step")
        del state, step
    log(f"phase train_stage1: {time.perf_counter() - t0:.2f} s")
    del s1_batch

    t0 = time.perf_counter()
    stage1_train_reference(args.seed, device)
    log(f"phase train_stage1_reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    chain = run_stage1_cli(args.seed, device)
    tv = chain["train_vqvae"]
    log(f"phase train_stage1_entry: {time.perf_counter() - t0:.2f} s; train_vqvae -bf16 "
        f"epochs {tv['epochs']} (the third after -resume) train loss "
        f"{[round(v, 4) for v in tv['train_loss']]}, {tv['steps']} steps, "
        f"{tv['seconds'][0]:.2f} s + {tv['seconds'][1]:.2f} s; extract_features "
        f"{chain['extract_features']}; train_latent losses "
        f"{[round(v, 4) for v in chain['train_latent']['losses']]}; test --experiment recon "
        f"--vae_ckpt rmsd_aligned {chain['test_recon']['rmsd_aligned']:.4f}, ged "
        f"{chain['test_recon']['ged']:.4f}")
    log(f"total: {time.perf_counter() - t_start:.2f} s")

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
