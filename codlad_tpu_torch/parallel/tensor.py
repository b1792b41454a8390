"""Data x tensor parallelism of the Stage-2 training step over torch.distributed.

Counterpart of the data x tensor configuration of the JAX package's
`dryrun_multichip` (__graft_entry__.py:163-200), where GSPMD shards every
2-d parameter whose trailing dim divides by the 'model' axis and is at
least 128 (`shard_param`), AdamW's moments and the EMA with it, and places
the collectives. The ranks here form a ('data', 'model') layout, rank =
data_rank * model + model_rank, the model ranks of one data row
consecutive.

The port's kernels take whole weight matrices, so a sharded parameter is
stored as a column shard on each model rank (with its moments and EMA) and
gathered whole for the forward. The model ranks of one data row then
compute the same rows: the gather's backward is the slice of the gradient
that this rank's shard owns, and only the data axis sums it (summing over
the model axis too would multiply it by the model size). The step itself
is train/steps.make_latent_step on `TensorMesh.data_mesh` (the data ranks
of this rank's model index: global counts, the gradient all-reduce), with
a `ShardedTrainState`, whose `params` are the gathered tensors and whose
`apply_gradients` takes that slice and updates only the local shard.

JAX's rule is stated in flax layout: the trailing dim of a Dense kernel
[in, out] is a torch Linear weight's dim 0; the raw chain weights (W_e,
W2, W3) and embeddings keep flax's layout, so their trailing dim is the
last.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from codlad_tpu_torch.train.mesh import Mesh
from codlad_tpu_torch.train.state import TrainState, global_norm


def shard_plan(model, model_shards, min_width=128):
    """{parameter name: the torch dim holding flax's trailing dim} for every
    2-d parameter that JAX's `shard_param` shards on a model axis of
    `model_shards`: that dim divides by it and is at least min_width."""
    modules = dict(model.named_modules())
    plan = {}
    for name, p in model.named_parameters():
        if p.dim() != 2:
            continue
        owner = modules[name.rpartition(".")[0]]
        dim = 0 if isinstance(owner, nn.Linear) and name.endswith(".weight") else 1
        if p.shape[dim] % model_shards == 0 and p.shape[dim] >= min_width:
            plan[name] = dim
    return plan


@dataclasses.dataclass(eq=False)
class TensorMesh:
    """The ('data', 'model') layout of the ranks: `data_mesh` spans the data
    ranks of this rank's model index, `model_group` the model ranks of its
    data row (None in a plain process or with one model rank)."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_mesh: Any = None
    model_group: Any = None


def make_tensor_mesh(model_shards=1):
    """The TensorMesh of the current process group: world / model_shards
    data rows of model_shards ranks each (a plain process: one rank, no
    collectives). Every rank must call it, in the same order (it makes the
    process groups)."""
    tp = max(int(model_shards), 1)
    if not dist.is_initialized():
        if tp != 1:
            raise ValueError(f"{tp} model shards need a process group of {tp} ranks")
        return TensorMesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f"model_shards {tp} must divide the world size {world}")
    data = world // tp
    data_group = model_group = None
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(data)])
        if m == rank % tp:
            data_group = g
    for d in range(data):
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
        if d == rank // tp:
            model_group = g
    dr, mr = rank // tp, rank % tp
    data_mesh = Mesh(data=data, data_rank=dr, world_group=data_group, data_group=data_group)
    return TensorMesh(data=data, model=tp, data_rank=dr, model_rank=mr, data_mesh=data_mesh,
                      model_group=model_group if tp > 1 else None)


class ShardedTrainState:
    """A TrainState (AdamW, EMA, clipping) whose sharded parameters, with
    their moments and EMA, hold only this model rank's column shard.
    `params` gathers them whole; `apply_gradients` takes full-size grads
    (summed over the data axis), keeps this rank's slice of each sharded one
    and updates the local state; the clip norm is that of the full grads
    (the caller's, or computed here before the slice), the same on every
    model rank."""

    def __init__(self, params, plan, tmesh, lr_fn, **kwargs):
        self.plan, self.tmesh = plan, tmesh
        self.local = TrainState({k: self.slice(k, v) for k, v in params.items()}, lr_fn,
                                **kwargs)

    def slice(self, name, full):
        """This model rank's shard of a full-size tensor (the gather's backward)."""
        dim = self.plan.get(name)
        if dim is None or self.tmesh.model == 1:
            return full
        return full.chunk(self.tmesh.model, dim)[self.tmesh.model_rank].contiguous()

    def gather(self, name, local):
        dim = self.plan.get(name)
        if dim is None or self.tmesh.model_group is None:
            return local
        parts = [torch.empty_like(local) for _ in range(self.tmesh.model)]
        dist.all_gather(parts, local.contiguous(), group=self.tmesh.model_group)
        return torch.cat(parts, dim)

    @property
    def params(self):
        return {k: self.gather(k, v) for k, v in self.local.params.items()}

    def apply_gradients(self, grads, norm=None):
        if norm is None:
            norm = global_norm(grads)
        self.local.apply_gradients({k: self.slice(k, g) for k, g in grads.items()}, norm)

    def update_ema(self, decay):
        self.local.update_ema(decay)

    def local_bytes(self):
        """Bytes of this rank's sharded params, their two moments and EMA."""
        st = self.local
        trees = [st.params, st.opt_state["mu"], st.opt_state["nu"]] + (
            [st.ema_params] if st.ema_params is not None else [])
        return sum(t[k].numel() * t[k].element_size() for t in trees for k in self.plan)
