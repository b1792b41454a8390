"""Data and sequence parallelism over torch.distributed.

Counterpart of codlad_tpu/train/mesh.py. The JAX package lays a 1-D or
('data', 'seq') mesh over its chips and lets XLA insert the collectives;
here every rank is one process on one device (torchrun's layout), and the
collectives are explicit:

* `maybe_init_distributed` joins the process group that torchrun's
  environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
  describes, NCCL for CUDA and gloo for the CPU; in a plain process it does
  nothing.
* `Mesh` is the ('data', 'seq') layout of the ranks: rank = data_rank *
  seq + seq_rank, the seq ranks of one data row consecutive, as
  `make_mesh_2d` lays them out. Its `world_sum` sums a tensor over every
  rank; `data_sum` over the data axis, `seq_sum` / `seq_max` over one data
  row's seq ranks; `sum_grads` is the data-parallel gradient all-reduce
  (one flat buffer, summed over every rank).

The Stage-2 and distillation steps (train/steps.py) divide each rank's
loss by GLOBAL counts (valid samples; under seq sharding also the masked
residues of each sample), so every rank's loss is a partial sum of the
global batch's loss and the SUM of the ranks' gradients is the gradient of
the global batch, as JAX's psum over the mesh gives it. The Stage-1 step's
masked means take their global denominators from `data_sum`, which sums
over the data axis while a step runs under `summing_over(mesh)` and is the
identity otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device):
    """NCCL for CUDA devices, gloo for the CPU: no other pairing, and no
    switch from one to the other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_init_distributed(device="cuda"):
    """Join torchrun's process group when its environment is set (WORLD_SIZE
    and MASTER_ADDR), with `backend_for(device)`; on CUDA the rank's device
    is LOCAL_RANK. A no-op in a plain process or when the group exists.
    Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return 0, 1
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def rank_device(device):
    """The device of this rank: cuda:LOCAL_RANK for a CUDA device given
    without an index under torchrun, else `device` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def is_main_process():
    return not dist.is_initialized() or dist.get_rank() == 0


def pad_batch_to_devices(batch, n_devices):
    """Pad the batch dim of every array to a multiple of n_devices; the
    padded samples get all-False masks (np.pad's zeros), so they contribute
    nothing."""
    B = next(iter(batch.values())).shape[0]
    rem = (-B) % n_devices
    if rem == 0:
        return batch
    return {k: np.pad(v, [(0, rem)] + [(0, 0)] * (v.ndim - 1)) for k, v in batch.items()}


def local_rows(batch, rank, world):
    """This rank's block of rows of a global batch dict (arrays or tensors
    with a batch dim divisible by `world`): the counterpart of shard_batch."""
    B = next(iter(batch.values())).shape[0]
    if B % world:
        raise ValueError(f"batch {B} does not divide by {world} ranks")
    n = B // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


@dataclasses.dataclass(eq=False)
class Mesh:
    """The ('data', 'seq') layout of the ranks and its process groups: None
    in a plain process, where every reduction is the identity; under a
    process group every reduction is a collective, also over one rank (a
    torchrun launch of one process runs its NCCL calls)."""

    data: int = 1
    seq: int = 1
    data_rank: int = 0
    seq_rank: int = 0
    world_group: Any = None    # every rank
    data_group: Any = None     # the ranks of this rank's seq index
    seq_group: Any = None      # the ranks of this rank's data row (seq mode)
    seq_ranks: tuple = (0,)    # global ranks of this rank's data row, in seq order
    seq_mode: bool = False     # the network runs its seq mode (even on one seq rank)

    @property
    def world(self):
        return self.data * self.seq

    @property
    def rank(self):
        return self.data_rank * self.seq + self.seq_rank

    @staticmethod
    def _reduce(x, group, op=dist.ReduceOp.SUM):
        if group is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    def world_sum(self, x):
        return self._reduce(x, self.world_group)

    def data_sum(self, x):
        return self._reduce(x, self.data_group)

    def seq_sum(self, x):
        return self._reduce(x, self.seq_group)

    def seq_max(self, x):
        return self._reduce(x, self.seq_group, dist.ReduceOp.MAX)

    def data_gather(self, x):
        """cat over the data axis of each rank's x (dim 0), no gradient."""
        if self.data_group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.data)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.data_group)
        return torch.cat(parts, 0)

    def sum_grads(self, grads):
        """The gradient all-reduce: every grad summed over every rank, through
        one flat buffer of each dtype."""
        if self.world_group is None:
            return grads
        keys = list(grads)
        out = dict(grads)
        for dt in {grads[k].dtype for k in keys}:
            ks = [k for k in keys if grads[k].dtype == dt]
            flat = torch.cat([grads[k].reshape(-1) for k in ks])
            dist.all_reduce(flat, group=self.world_group)
            off = 0
            for k in ks:
                n = grads[k].numel()
                out[k] = flat[off:off + n].view_as(grads[k])
                off += n
        return out

    def seq_ctx(self):
        """The denoiser's `seq` argument (parallel/sequence.SeqGroup) for
        this rank's data row, or None without sequence sharding."""
        if not self.seq_mode:
            return None
        from codlad_tpu_torch.parallel.sequence import SeqGroup
        return SeqGroup(self.seq_group, self.seq, self.seq_rank, self.seq_ranks)


def make_mesh(seq_shards=1, seq_mode=False):
    """The Mesh of the current process group: world / seq_shards data rows
    of seq_shards ranks each (a plain process: one rank). Every rank must
    call it, in the same order, since it makes the process groups.
    seq_mode=True runs the seq-mode network even at one seq rank."""
    seq = max(int(seq_shards), 1)
    if not dist.is_initialized():
        if seq != 1:
            raise ValueError(f"{seq} seq shards need a process group of {seq} ranks")
        return Mesh(seq_mode=seq_mode)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % seq:
        raise ValueError(f"seq_shards {seq} must divide the world size {world}")
    data = world // seq
    seq_mode = seq_mode or seq > 1
    data_group = seq_group = None
    seq_ranks = tuple(range((rank // seq) * seq, (rank // seq + 1) * seq))
    # new_group is collective: every rank makes every group, in one order
    for s in range(seq):
        g = dist.new_group([d * seq + s for d in range(data)])
        if s == rank % seq:
            data_group = g
    for d in range(data):
        g = dist.new_group(list(range(d * seq, (d + 1) * seq))) if seq_mode else None
        if d == rank // seq:
            seq_group = g
    return Mesh(data=data, seq=seq, data_rank=rank // seq, seq_rank=rank % seq,
                world_group=dist.group.WORLD, data_group=data_group, seq_group=seq_group,
                seq_ranks=seq_ranks, seq_mode=seq_mode)


_SUMMING = None    # the Mesh whose data axis `data_sum` reduces over, while a step runs


@contextlib.contextmanager
def summing_over(mesh):
    """Within the block, `data_sum` sums over mesh's data axis (a Mesh of one
    rank, or None, sums nothing)."""
    global _SUMMING
    prev, _SUMMING = _SUMMING, (mesh if mesh is not None and mesh.data_group is not None
                                else None)
    try:
        yield
    finally:
        _SUMMING = prev


def data_sum(x):
    """x summed over the data axis of the step that runs (see
    `summing_over`); x itself outside one. No gradient flows through."""
    return x if _SUMMING is None else _SUMMING.data_sum(x)


def data_size():
    """The data-axis size of the step that runs (1 outside one)."""
    return 1 if _SUMMING is None else _SUMMING.data
