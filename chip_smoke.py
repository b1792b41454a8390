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
  3. slice   -- the Stage-2 inference path at full width: a synthetic CG
                batch of 96 frames x 128 residues, 100 respaced ancestral
                steps of the 3+3-layer bf16 denoiser, VQ snap, IC decode
                and xyz14 in f32, with the kernels' launch counts read
                around it;
  4. timing  -- one more 100-step sample_and_decode, timed;
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
                and EMA.

Sampling weights are the port's init from --seed with the adaLN heads (zero
at init) drawn small and random, so that every layer reaches the output;
the training phases start from the plain init, as the trainer does. The line
before the last is the card's name and power limit from nvidia-smi; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

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
}


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
        vae=VAE(gen).to(device).eval(), codebook=codebook.to(device),
        norm_mean=[0.0, 0.0, 0.0], norm_std=[1.0, 1.0, 1.0],
        compute_dtype=compute_dtype)


def run_slice(pipe, batch, generator):
    """Drive the main path once and read the kernels' launch counts around
    it: {latents, ic, xyz14, seconds, launches}."""
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK

    dev = batch["res_type"].device
    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    MK.reset_launches()
    t0 = time.perf_counter()
    lat = pipe.sample_latents(extras, generator=generator)
    ic, xyz = pipe.decode(batch, lat)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"latents": lat, "ic": ic, "xyz14": xyz, "seconds": seconds,
            "launches": dict(MK.LAUNCHES)}


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


def kernel_inputs(dtype, seed, device):
    """Full-width K1/K2 operands in the layout the main path gives them."""
    import torch
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(device)
    return dict(
        A=r(B, L, H).to(dtype), E=r(B, L, K, H).to(dtype), Gn=r(B, L, H).to(dtype),
        idx=torch.randint(0, L, (B, L, K), generator=g, dtype=torch.int32).to(device),
        mask=(torch.rand(B, L, K, generator=g) > 0.2).float().to(device),
        W_e=r(H, H, sc=H ** -0.5).to(dtype), W2=r(H, H, sc=H ** -0.5).to(dtype),
        b2=r(H, sc=0.1), W3=r(H, H, sc=H ** -0.5).to(dtype), b3=r(H, sc=0.1),
        sh=r(B, H, sc=0.3), sc=r(B, H, sc=0.3), g=r(B, H))


def kernel_calls(x):
    """{name: (kernel call, plain call, bytes moved, matmul flops)}."""
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    es = x["E"].element_size()
    n_edge = B * L * K
    chain_in = (B * L * H + n_edge * H + B * L * H) * es + n_edge * 4 + 3 * H * H * es + 2 * H * 4
    s_args = [x[k] for k in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")]
    e_args = [x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3",
                             "sh", "sc", "g")]
    return {
        "fused_message_sum": (
            lambda: MK.fused_message_sum(*s_args, 30.0),
            lambda: MK.ref_message_sum(*s_args, 30.0),
            chain_in + n_edge * 4 + B * L * H * 4,
            2 * 2 * n_edge * H * H + 2 * B * L * H * H),
        "fused_message_edge_lnmod": (
            lambda: MK.fused_message_edge_lnmod(*e_args),
            lambda: MK.ref_message_edge_lnmod(*e_args),
            chain_in + 3 * B * H * 4 + n_edge * H * es,
            3 * 2 * n_edge * H * H),
    }


def time_pair(kernel, plain, reps=10):
    """Median ms of each, timed with CUDA events in alternating order."""
    import torch
    times = {"kernel": [], "plain": []}
    for i in range(reps):
        order = [("kernel", kernel), ("plain", plain)]
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def check_kernels(device, seed):
    """Every kernel against its plain version, both dtypes; returns the
    bf16 (main-path dtype) record of each kernel."""
    import torch
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        x = kernel_inputs(dtype, seed, device)
        atol, rtol = TOL[dname]
        for name, (kern, plain, nbytes, flops) in kernel_calls(x).items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            ms, plain_ms = time_pair(kern, plain)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_OPS[dname] * 1e3
            log(f"kernel {name} {dname}: max|d|={err:.3g} (atol {atol:g} + rtol {rtol:g}*|ref|) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP)")
            if not ok:
                raise RuntimeError(f"{name} ({dname}) disagrees with its plain version")
            if dtype == torch.bfloat16:
                records[name] = record(name, err, ms, plain_ms, t_bytes, t_ops)
        del x
    return records


def record(name, err, ms, plain_ms, t_bytes, t_ops):
    """One row of the `kernels` JSON line (launches filled in later)."""
    replaces, source = KERNELS[name]
    return {"name": name, "route": "cuda", "source": f"codlad_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


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


def bwd_bytes_flops(es, edge):
    """Bytes (each input read once, each output written once) and matmul
    flops of K3 (edge=False) or K4 / K5's backward (edge=True)."""
    n_edge, n_node = B * L * K, B * L
    nbytes = ((2 * n_node * H + n_edge * H) * es + n_edge * 4 + 3 * H * H * es + 2 * H * 4
              + n_node * H * 4 + n_edge * H * es + n_node * H * 4      # dA, dE, dGn
              + 3 * H * H * 4 + 2 * H * 4)                              # weight grads
    if edge:   # + sc, g, dout; dsh, dsc, dgate
        nbytes += 2 * B * H * 4 + n_edge * H * es + 3 * B * H * 4
        flops = 9 * 2 * n_edge * H * H
    else:      # + mask, dout f32 [B, L, H]
        nbytes += n_edge * 4 + n_node * H * 4
        flops = 6 * 2 * n_edge * H * H + 2 * 2 * n_node * H * H
    return nbytes, flops


def check_bwd_kernels(device, seed):
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
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        x = kernel_inputs(dtype, seed, device)
        g = torch.Generator().manual_seed(seed + 7)
        ct_sum = torch.randn(B, L, H, generator=g).to(device)
        ct_edge = torch.randn(B, L, K, H, generator=g).to(device).to(dtype)
        seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=g, dtype=torch.int32).to(device)
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
        err = compare_grads("K3", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(lambda *a: MK.ref_message_sum(*a, 30.0), x, _SUM_KEYS,
                                   _DIFF, ct_sum)
        sum_args = args(("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3"))
        dout = ct_sum / 30.0
        ms, plain_ms = time_pair(lambda: MK.message_sum_bwd(*sum_args, dout), plain_bwd)
        recs = {"fused_message_sum_bwd": (err, ms, plain_ms, *bwd_bytes_flops(es, False))}
        del gk, plain_bwd

        # K4 through K2's autograd wrapper
        _, gk, _ = grads_of(MK.fused_message_edge_lnmod, x, _EDGE_KEYS, edge_diff, ct_edge)
        _, gp, _ = reference(MK.ref_message_edge_lnmod, _EDGE_KEYS, edge_diff, ct_edge)
        err = compare_grads("K4", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(MK.ref_message_edge_lnmod, x, _EDGE_KEYS, edge_diff,
                                   ct_edge)
        bwd_args = args(("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sc", "g"))
        ms, plain_ms = time_pair(lambda: MK.message_edge_lnmod_bwd(*bwd_args, ct_edge),
                                 plain_bwd)
        recs["fused_message_edge_lnmod_bwd"] = (err, ms, plain_ms, *bwd_bytes_flops(es, True))
        del gk, plain_bwd

        # K5: the seeded forward's mask, its rate, its output and its backward
        out, mask = MK.edge_lnmod_pdrop_debug(*args(_EDGE_KEYS), seeds, P_DROP)
        want_mask = MK.keep_scales(seeds, (L, K, H), P_DROP)
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
        ms, plain_ms = time_pair(
            lambda: MK.fused_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP),
            lambda: MK.plain_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP))
        k2_bytes, k2_flops = kernel_calls(x)["fused_message_edge_lnmod"][2:]
        recs["fused_message_edge_lnmod_drop"] = (fwd_err, ms, plain_ms, k2_bytes + B * 4,
                                                 k2_flops)
        pd = lambda *a: MK.fused_message_edge_lnmod_pdrop(*a, seeds, P_DROP)
        plain_pd = lambda *a: MK.plain_message_edge_lnmod_pdrop(*a, seeds, P_DROP)
        _, gk, _ = grads_of(pd, x, _EDGE_KEYS, edge_diff, ct_edge)
        _, gp, _ = reference(plain_pd, _EDGE_KEYS, edge_diff, ct_edge)
        err = compare_grads("K5 seeded", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(plain_pd, x, _EDGE_KEYS, edge_diff, ct_edge)
        ms, plain_ms = time_pair(
            lambda: MK.message_edge_lnmod_bwd(*bwd_args, ct_edge, seeds=seeds, p=P_DROP),
            plain_bwd)
        nbytes, flops = bwd_bytes_flops(es, True)
        recs["fused_message_edge_lnmod_drop_bwd"] = (err, ms, plain_ms, nbytes + B * 4, flops)
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
        compare_grads("K5 keep", gk, gp, dname)
        del gk, gp, out_k, out_p, keep, want_mask, x, xr
        torch.cuda.empty_cache()

        for name, (err, ms, plain_ms, nbytes, flops) in recs.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_OPS[dname] * 1e3
            log(f"kernel {name} {dname}: max|d|={err:.3g}; kernel {ms:.4f} ms, plain "
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


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_summary(prof, wall_ms, n_steps, top=12):
    """Log the device's busy share of the traced wall time (the union of
    kernel intervals) and the kernels by device time a step, the
    message-chain kernels (K1-K5) summed apart."""
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
    chain = sum(us for k, (us, _) in by_name.items() if any(c in k for c in CHAIN_KERNELS))
    log(f"  trace of {n_steps} steps ({wall_ms / n_steps:.2f} ms/step wall): device busy "
        f"{busy:.3f} (idle {1 - busy:.3f}); kernels {total / 1e3 / n_steps:.2f} ms/step, "
        f"message-chain kernels {chain / 1e3 / n_steps:.2f} ms ({chain / total:.3f}), other "
        f"{(total - chain) / 1e3 / n_steps:.2f} ms; "
        f"{sum(n for _, n in by_name.values()) // n_steps} launches a step")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3 / n_steps:9.3f} ms/step {n // n_steps:5d}x  {name[:100]}")


def run_train(state, step, x1, extras, seed, n_steps, expect, traced=0):
    """n_steps training steps with every step's launches counted and held
    to `expect` (zero for any kernel it does not name); the last `traced`
    of them run under torch.profiler, whose summary is logged. Returns the
    ms of the untraced steps, the last metrics and the launch totals."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    cuda = x1.device.type == "cuda"
    p0 = {k: v.clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    totals, times = dict.fromkeys(MK.LAUNCHES, 0), []
    with contextlib.ExitStack() as stack:
        for i in range(n_steps):
            if i == n_steps - traced:
                prof = stack.enter_context(profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            if cuda:
                torch.cuda.synchronize()
            MK.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step(state, x1, extras, seed + i)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = dict(MK.LAUNCHES)
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
              "fused_message_edge_lnmod": steps * n_enc}
    log(f"phase slice: {time.perf_counter() - t0:.2f} s; launches {out['launches']} "
        f"(expected {expect}); xyz14 {tuple(out['xyz14'].shape)} finite")
    for name, n in out["launches"].items():
        if n != expect.get(name, 0):  # expect > 0: a kernel never launched fails too
            raise RuntimeError(f"{name} launched {n} times on the main path, "
                               f"expected {expect.get(name, 0)}")
    for name in expect:
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
    log(f"total: {time.perf_counter() - t_start:.2f} s")

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
