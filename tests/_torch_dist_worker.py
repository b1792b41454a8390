"""Spawned gloo ranks for the port's multi-rank tests (torch only, no JAX).

`spawn(world, case, tmp, **kwargs)` starts `world` processes, each joining
a gloo group through a file store under `tmp` (unique per test, so tests
running side by side never share one), runs the case function of this
module named `case` as case(rank, world, **kwargs) and returns the ranks'
results, which each rank saves with torch.save.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


def _run(rank, world, store, case, out, kwargs):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    try:
        res = globals()[case](rank, world, **kwargs)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world, case, tmp, **kwargs):
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{case}_{world}")
    torch.multiprocessing.spawn(_run, args=(world, store, case, tmp, kwargs), nprocs=world)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _cols(rank, world, L):
    n = L // world
    return slice(rank * n, (rank + 1) * n)


def _model(sd, cfg):
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    model = MPNNDenoiser(torch.Generator().manual_seed(0), **cfg)
    model.load_state_dict(sd)
    return model


# ---------------------------------------------------------------------------
# cases


def ring_knn_case(rank, world, Ca, mask, k):
    from codlad_tpu_torch.parallel.sequence import SeqGroup, ring_knn
    cols = _cols(rank, world, Ca.shape[1])
    seq = SeqGroup(dist.group.WORLD, world, rank, tuple(range(world)))
    return ring_knn(Ca[:, cols], mask[:, cols], k, seq)


def seq_forward_case(rank, world, sd, cfg, x, t, res, cg, mask):
    """This rank's rows of the seq-mode forward and the grads of sum(out^2)
    summed over the ranks (the dense loss's grads)."""
    from codlad_tpu_torch.train.mesh import make_mesh
    model = _model(sd, cfg)
    seq = make_mesh(world).seq_ctx()
    c = _cols(rank, world, x.shape[1])
    out = model(x[:, c], t, res[:, c], cg[:, c], mask[:, c], seq=seq)
    params = list(model.parameters())
    grads = torch.autograd.grad((out ** 2).sum(), params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    for g in grads:
        dist.all_reduce(g)
    names = [n for n, _ in model.named_parameters()]
    return out.detach(), dict(zip(names, grads))


def latent_step_case(rank, world, sd, cfg, x1, extras, dropout, seq_shards=1, seed=3,
                     kind="diffusion", class_dropout_prob=0.0):
    """The state after one make_latent_step on this rank's block of the
    global batch (the mesh's data x seq layout)."""
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.gen.flow import FLOW_MATCHERS
    from codlad_tpu_torch.train.mesh import make_mesh
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_latent_step
    mesh = make_mesh(seq_shards)
    model = _model(sd, cfg)
    state = TrainState(dict(model.named_parameters()), lambda s: np.float32(1e-3),
                       grad_clip=1.0)
    process = create_diffusion(None) if kind == "diffusion" else FLOW_MATCHERS[kind]()
    step, _ = make_latent_step(model, process, process_kind=kind, dropout=dropout > 0,
                               class_dropout_prob=class_dropout_prob, mesh=mesh)
    B, L = x1.shape[:2]
    b = B // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    cols = _cols(mesh.seq_rank, mesh.seq, L)
    state, m = step(state, x1[rows, cols], {k: v[rows, cols] for k, v in extras.items()},
                    seed)
    return {"params": state.params, "ema": state.ema_params, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"])}


def tensor_step_case(rank, world, sd, cfg, x1, extras, dropout, model_shards, seed=3):
    """One make_latent_step on a (world / model_shards) x model_shards data x
    model layout (parallel/tensor.py), and the same step on the same data
    ranks with every parameter whole: the gathered params and EMA, loss,
    grad_norm, whether the update equals the unsharded one bit for bit, the
    sharded parameters' count and this rank's bytes of them."""
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.parallel.tensor import ShardedTrainState, make_tensor_mesh, shard_plan
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_latent_step
    tmesh = make_tensor_mesh(model_shards)
    mesh = tmesh.data_mesh
    b = x1.shape[0] // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    lr = lambda s: np.float32(1e-3)
    out = {}
    for name in ("sharded", "whole"):
        model = _model(sd, cfg)
        params = dict(model.named_parameters())
        state = (ShardedTrainState(params, shard_plan(model, model_shards), tmesh, lr,
                                   grad_clip=1.0) if name == "sharded"
                 else TrainState(params, lr, grad_clip=1.0))
        step, _ = make_latent_step(model, create_diffusion(None), dropout=dropout > 0,
                                   mesh=mesh)
        state, m = step(state, x1[rows], {k: v[rows] for k, v in extras.items()}, seed)
        out[name] = (state, m)
    st, m = out["sharded"]
    whole = out["whole"][0]
    ema = {k: st.gather(k, v) for k, v in st.local.ema_params.items()}
    params = st.params
    return {"params": params, "ema": ema, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "equal": all(torch.equal(params[k], v) for k, v in whole.params.items())
            and all(torch.equal(ema[k], v) for k, v in whole.ema_params.items()),
            "n_sharded": len(st.plan), "bytes": st.local_bytes()}


def stage1_step_case(rank, world, batch, sd, vq, weights):
    """The state and metrics after one data-parallel make_vqvae_step."""
    from codlad_tpu_torch.models.vae import VAE
    from codlad_tpu_torch.models.vq import VQState
    from codlad_tpu_torch.train.mesh import local_rows, make_mesh
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_vqvae_step
    mesh = make_mesh(1)
    vae = VAE(torch.Generator().manual_seed(0), embed_dim=36, vqdim=3, enc_nconv=1,
              dec_nconv=1)
    vae.load_state_dict(sd)
    state = TrainState(dict(vae.named_parameters()), lambda s: np.float32(1e-3),
                       grad_clip=5.0, weight_decay=1e-4, ema=False,
                       vq_state=VQState(*[v.clone() for v in vq]))
    step, _ = make_vqvae_step(vae, mesh=mesh)
    state, m = step(state, local_rows(batch, rank, world), weights)
    return {"params": state.params, "vq": state.vq_state.tensors(),
            "metrics": {k: float(v) for k, v in m.items()}}


def cli_case(rank, world, module, argv):
    """`main(argv)` of a CLI module of the port on this rank; its result
    where it is a dict (cli.test's summary)."""
    import importlib
    out = importlib.import_module(module).main(argv)
    return out if isinstance(out, dict) else None


def dryrun_case(rank, world):
    from codlad_tpu_torch.parallel.dryrun import dryrun_multichip
    return dryrun_multichip("cpu")
