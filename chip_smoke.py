#!/usr/bin/env python3
"""Smoke run of the PyTorch port (codlad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its seconds:
  1. build   -- compile csrc/*.cu with plain nvcc (one process per source);
  2. kernels -- K1 (fused_message_sum) and K2 (fused_message_edge_lnmod) at
                the bench shape (B96 L128 K64 H128), bf16 and f32, against
                their plain PyTorch versions on the same inputs, timed with
                CUDA events beside their bound;
  3. slice   -- the Stage-2 inference path at full width: a synthetic CG
                batch of 96 frames x 128 residues, 100 respaced ancestral
                steps of the 3+3-layer bf16 denoiser, VQ snap, IC decode
                and xyz14 in f32, with the kernels' launch counts read
                around it;
  4. timing  -- one more 100-step sample_and_decode, timed;
  5. reference -- a small batch through the same path in f32 on the card
                and with the plain versions on the CPU, same weights and
                noise (kNN indices, one denoise call, 10 sampling steps,
                decode).

Weights are the port's init from --seed with the adaLN heads (zero at init)
drawn small and random, so that every layer reaches the output. The line
before the last is the card's name and power limit from nvidia-smi; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
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
KERNELS = {
    "fused_message_sum": "codlad_tpu/kernels/mpnn_kernels.py:395",
    "fused_message_edge_lnmod": "codlad_tpu/kernels/mpnn_kernels.py:519",
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
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": "codlad_tpu_torch/csrc/message_chain.cu",
                    "replaces": KERNELS[name], "launches": 0, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None}
        del x
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
        if n != expect[name]:  # expect > 0: a kernel never launched fails too
            raise RuntimeError(f"{name} launched {n} times on the main path, "
                               f"expected {expect[name]}")
        records[name]["launches"] = n

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
    log(f"total: {time.perf_counter() - t_start:.2f} s")

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
