"""A multi-rank dry run of the port's parallel training paths.

Twin of `dryrun_multichip` (__graft_entry__.py): each configuration runs
one f32 step on the ranks of the current process group and is held as the
JAX function holds its own:

1. dp: a Stage-2 diffusion step at dropout 0.1, the batch split over every
   rank (the data axis), against one rank's step on the whole batch (the
   masks are keyed by the global rows): the loss within 1e-4, the updated
   params' largest difference reported (the CPU tests hold those).
2. and 4. dp x sp, the ring-kNN seq train step (the cli.train_latent
   --seq_shards path): the step on a (world / 2) x 2 data x seq mesh at
   dropout 0 (the seq ranks draw masks of their own), |delta loss| < 1e-4
   against the dense step. JAX's GSPMD data x seq step (2) and its
   shard_map seq step (4) are one path in the port.
3. ring-kNN seq forward: the denoiser on the largest of 1, 2, 4 seq ranks
   that divides the world against the dense forward, max |delta| < 1e-3.
5. Stage 1: a VQ-VAE step with the EMA codebook update, data-parallel,
   against one rank: |delta loss| < 1e-4, max |delta codebook| < 2e-5.

With one rank, 1 and 5 compare one rank with itself and 2-4 run the
seq-mode network on one seq rank (its ring and gathers of one block); with
an odd world size 2 and 4 do too. The
JAX function's data x tensor configuration (GSPMD sharding the weights) is
not here: the port's kernels take whole weight matrices (ROADMAP queue 1
item 11).

    torchrun --nproc_per_node 4 -m codlad_tpu_torch.parallel.dryrun   # cards, NCCL
    python -m codlad_tpu_torch.parallel.dryrun --device cpu --nproc 4  # gloo ranks
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _inputs(B, L, seed, device, world):
    """(x, res_type, cg, mask) of B random C-alpha walks (one frame with a
    masked tail), padded with all-masked rows to a multiple of the ranks
    (`pad_batch_to_devices`, as JAX pads its batch to the mesh)."""
    from codlad_tpu_torch.data.synthetic import random_ca_trace
    from codlad_tpu_torch.train.mesh import pad_batch_to_devices
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.float32)
    mask[1, L - 5:] = 0.0
    host = pad_batch_to_devices(
        {"x": rng.normal(size=(B, L, 3)).astype(np.float32),
         "res_type": rng.integers(0, 20, size=(B, L)),
         "cg": np.stack([random_ca_trace(rng, L) for _ in range(B)]).astype(np.float32),
         "mask": mask}, world)
    return [torch.as_tensor(host[k], device=device) for k in ("x", "res_type", "cg", "mask")]


def _denoiser(device, dropout):
    """The production denoiser (k 16), its zero-initialised adaLN heads drawn
    small, so that every layer and every dropout mask reaches the loss."""
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    gen = torch.Generator().manual_seed(0)
    model = MPNNDenoiser(gen, dropout=dropout, k_neighbors=16)
    with torch.no_grad():
        for layer in [*model.enc_layers, *model.dec_layers, model.w_out]:
            for p in layer.Dense_0.parameters():
                p.normal_(0.0, 0.02, generator=gen)
    return model.to(device)


def _latent_step(model, mesh, x1, extras, dropout, seed=0):
    """(loss, the state after one step) of make_latent_step on the block of
    the global batch (x1, extras) that `mesh` gives this rank (None: all)."""
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_latent_step
    state = TrainState(dict(model.named_parameters()), lambda s: np.float32(3e-4),
                       grad_clip=1.0)
    step, _ = make_latent_step(model, create_diffusion(None), dropout=dropout > 0, mesh=mesh)
    if mesh is not None:
        B, L = x1.shape[:2]
        b, n = B // mesh.data, L // mesh.seq if mesh.seq_mode else L
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        cols = slice(mesh.seq_rank * n, (mesh.seq_rank + 1) * n) if mesh.seq_mode \
            else slice(None)
        x1 = x1[rows, cols]
        extras = {k: v[rows, cols] for k, v in extras.items()}
    state, m = step(state, x1, extras, seed)
    return float(m["loss"]), state


def _say(msg):
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(msg, flush=True)


def dryrun_multichip(device="cuda"):
    """Run the five configurations on the ranks of the process group (or
    one rank without one); raise AssertionError where one disagrees.
    Returns {configuration: its measured difference}."""
    from codlad_tpu_torch.train import mesh as mesh_mod

    world = dist.get_world_size() if dist.is_initialized() else 1
    out = {}
    B, L = max(2 * world, 8), 32
    x, res_type, cg, mask = _inputs(B, L, 1, device, world)
    B = x.shape[0]
    extras = {"res_type": res_type, "cg_xyz": cg, "mask": mask}

    # 1. dp, against one rank on the global batch
    mesh = mesh_mod.make_mesh(1)
    loss, st = _latent_step(_denoiser(device, 0.1), mesh, x, extras, 0.1)
    ref_loss, ref = _latent_step(_denoiser(device, 0.1), None, x, extras, 0.1)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    dp = max(float((st.params[k] - ref.params[k]).abs().max()) for k in ref.params)
    assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss)), (loss, ref_loss, dp)
    out["dp"] = abs(loss - ref_loss)
    _say(f"dryrun_multichip({world}): dp ok, loss={loss:.4f}, |dloss| vs 1 rank "
         f"{out['dp']:.2e}, max|dparam| {dp:.2e}")

    dense0, _ = _latent_step(_denoiser(device, 0.0), None, x, extras, 0.0)
    n_sp = 2 if world % 2 == 0 else 1
    # 2 and 4. the dp x sp (ring-kNN seq) train step at dropout 0 against dense
    mesh2 = mesh_mod.make_mesh(n_sp, seq_mode=True)
    loss2, _ = _latent_step(_denoiser(device, 0.0), mesh2, x, extras, 0.0)
    assert np.isfinite(loss2) and abs(loss2 - dense0) < 1e-4, (dense0, loss2)
    out["dp_x_sp_train"] = abs(loss2 - dense0)
    _say(f"dryrun_multichip({world}): dp x sp ring-kNN seq TRAIN ({mesh2.data}, "
         f"{mesh2.seq}) ok, loss={loss2:.4f}, |dloss| vs dense (no dropout) "
         f"{out['dp_x_sp_train']:.2e}")

    # 3. the seq forward on min(4, world) seq ranks against dense
    n_fwd = max(d for d in (1, 2, 4) if d <= world and world % d == 0)
    mesh3 = mesh_mod.make_mesh(n_fwd, seq_mode=True)
    model = _denoiser(device, 0.1).eval()
    t = torch.zeros((B,), dtype=torch.int64, device=device)
    n = L // n_fwd
    cols = slice(mesh3.seq_rank * n, (mesh3.seq_rank + 1) * n)
    with torch.no_grad():
        dense = model(x, t, res_type, cg, mask)
        sharded = model(x[:, cols], t, res_type[:, cols], cg[:, cols], mask[:, cols],
                        seq=mesh3.seq_ctx())
    err = (sharded - dense[:, cols]).abs().max()
    if dist.is_initialized():
        dist.all_reduce(err, op=dist.ReduceOp.MAX)   # the largest over the ranks
    err = float(err)
    assert np.isfinite(err) and err < 1e-3, f"seq-shard mismatch {err}"
    out["seq_forward"] = err
    _say(f"dryrun_multichip({world}): ring-kNN seq x{n_fwd} ok, max|d| vs dense {err:.2e}")

    # 5. Stage 1 with the EMA codebook, data-parallel against one rank
    l1, s1 = _stage1(device, None)
    l8, s8 = _stage1(device, mesh_mod.make_mesh(1))
    dcb = float((s8.vq_state.codebook - s1.vq_state.codebook).abs().max())
    assert np.isfinite(l8) and abs(l8 - l1) < 1e-4, (l1, l8)
    assert dcb < 2e-5, f"VQ-EMA codebook diverges under DP: {dcb}"
    out["stage1_dp"] = dcb
    _say(f"dryrun_multichip({world}): stage-1 vqvae dp ok, loss={l8:.4f}, "
         f"max|dcodebook| vs 1 rank {dcb:.2e}")
    return out


def _stage1(device, mesh):
    from codlad_tpu_torch.data.batch import collate, spec_for
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    from codlad_tpu_torch.models.vae import VAE
    from codlad_tpu_torch.models.vq import vq_init
    from codlad_tpu_torch.train.losses import LossWeights
    from codlad_tpu_torch.train.mesh import local_rows
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_vqvae_step, weights_to_array

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_frames = -(-max(world, 4) // world) * world
    exs = synthetic_examples(n_frames, 12, seed=5)
    hb = collate(exs, spec_for(exs, length_multiple=4, edge_multiple=64))
    if mesh is not None:
        hb = local_rows(hb, mesh.data_rank, mesh.data)
    batch = {k: torch.as_tensor(v, device=device) for k, v in hb.items()}
    gen = torch.Generator().manual_seed(0)
    vae = VAE(gen, embed_dim=36, vqdim=3, dec_nconv=2, enc_nconv=2).to(device)
    state = TrainState(dict(vae.named_parameters()), lambda s: np.float32(1e-3),
                       grad_clip=5.0, ema=False, vq_state=vq_init(gen, 64, 3, device=device))
    step, _ = make_vqvae_step(vae, mesh=mesh)
    state, m = step(state, batch, weights_to_array(LossWeights(eta=1.0, zeta=0.0)))
    return float(m["loss"]), state


def _spawned(rank, world, store, device):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    try:
        dryrun_multichip(device)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--nproc", type=int, default=0,
                   help="with --device cpu: spawn this many gloo ranks")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (--device cpu --nproc N runs gloo ranks)")
    if args.nproc:
        if torch.device(args.device).type != "cpu":
            raise SystemExit("--nproc spawns gloo ranks, which take --device cpu; on cards "
                             "launch with torchrun")
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(_spawned, args=(args.nproc, os.path.join(tmp, "store"),
                                                        "cpu"), nprocs=args.nproc)
        return
    from codlad_tpu_torch.train.mesh import maybe_init_distributed, rank_device
    dev = rank_device(args.device)
    maybe_init_distributed(dev)
    try:
        dryrun_multichip(dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
