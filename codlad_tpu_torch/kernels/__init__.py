"""The port's CUDA kernels: K1-K7 (mpnn_kernels), K8/K9 (edge_kernels),
K10 and K11 (tp_kernels). Each wrapper counts its launches; these two helpers read
and reset all the counts at once.

The JAX package's kernels/meshing.py has no twin here, because it needs no
code: it wraps each Pallas call in a shard_map over the batch axis so that
GSPMD does not gather the kernels' operands, and psums the per-shard weight
grads. Under the port's data parallelism (train/mesh.py) every rank is a
process that launches the kernels on its own rows, and the step's gradient
all-reduce (Mesh.sum_grads) sums the weight grads."""


def _modules():
    from codlad_tpu_torch.kernels import edge_kernels, mpnn_kernels, tp_kernels
    return mpnn_kernels, edge_kernels, tp_kernels


def reset_launches():
    for mod in _modules():
        mod.reset_launches()


def launch_counts():
    """{kernel name: launches since the last reset} over every kernel."""
    out = {}
    for mod in _modules():
        out.update(mod.LAUNCHES)
    return out
