"""K9's (edge aggregate's) summation order, repeated in torch.

csrc/edge_ops.cu's `aggregate_kernel` sums a node's listed edges (the CSR
of `codlad_tpu_torch.kernels.edge_kernels.build_csr`) in sub-slots of a
group of lanes, then through a fixed tree of warp shuffles. Nothing in the
port runs this module: it states that order for the checks.
tests/test_torch_aggregate_tiles.py holds it against the TPU kernel
(interpreted) and against a lane-by-lane walk of the kernel's loops on the
CPU; tests/test_torch_cuda.py and chip_smoke.py hold the kernel against it
bit for bit on the card. It imports torch only, so chip_smoke.py can load
it without JAX. `aggregate_layout` must pick what csrc/edge_ops.cu
`layout` and `aggregate` pick; the card's bit-for-bit checks fail where it
does not.
"""

import torch


def aggregate_layout(F, itemsize):
    """(V, C, S, W) of K9 (csrc/edge_ops.cu `aggregate`, `layout`) for rows
    of F elements of `itemsize` bytes: a lane takes V elements (the widest
    of 16, 8 and 4 bytes that divides F, else 1), C = F / V lanes a row; a
    node has a group of W lanes (halved from 32 while half still holds 4
    sub-slots), S = W / C sub-slots of them (1 where C >= W)."""
    V = next((nb // itemsize for nb in (16, 8, 4) if F % (nb // itemsize) == 0), 1)
    C = F // V
    W = 32
    while W // 2 >= 4 * C:
        W //= 2
    return V, C, (1 if C >= W else W // C), W


def csr_order_aggregate(csr, mask, msgs, n_nodes, reduce="sum"):
    """K9's sums in the kernel's order, in torch: node i's listed edges, q =
    0, 1, ... in list order, go to sub-slot (q % W) % S; each sub-slot sums
    mask * msg of its own in list order in f32 (masks are 0 or 1, as the
    featurizer's, so the product is exact, as in the kernel's fma); sub-slot
    s + off's sum is added to s's for off = P / 2, ..., 1 (P the power of
    two at or above S); the sum is cast to msgs' dtype. "mean" then divides
    by max(cast(degree), 1) in f32 and casts again; the degree sums the
    masks lane by lane (q % W), then over the group by the same tree. ->
    [B, n_nodes, F]."""
    B, E, F = msgs.shape
    dev, f32 = msgs.device, torch.float32
    _, _, S, W = aggregate_layout(F, msgs.element_size())
    ptr, edges = csr[0].long(), csr[1].long()
    total = ptr.numel() - 1
    node = torch.repeat_interleave(torch.arange(total, device=dev), ptr[1:] - ptr[:-1])
    q = torch.arange(edges.numel(), device=dev) - ptr[:-1][node]
    j, sub = q % W, (q % W) % S
    # earlier entries of the same sub-slot: (S-slot entries of a full W-id
    # chunk) x the chunks before, then this chunk's
    rank = (q // W) * ((W - sub + S - 1) // S) + j // S
    m = mask.reshape(-1).to(f32)[edges]
    vals = msgs.reshape(-1, F).to(f32)[edges] * m[:, None]
    parts = torch.zeros((total * S, F), dtype=f32, device=dev)
    slot = node * S + sub
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r                     # one entry a sub-slot
        parts[slot[sel]] = parts[slot[sel]] + vals[sel]
    parts = parts.reshape(total, S, F)
    off = 1
    while off < S:
        off *= 2
    off //= 2
    while off:
        new = parts.clone()
        new[:, :S - off] = parts[:, :S - off] + parts[:, off:]
        parts, off = new, off // 2
    out = parts[:, 0].to(msgs.dtype)
    if reduce == "mean":
        lanes = torch.zeros((total * W,), dtype=f32, device=dev)
        for k in range(int((q // W).max()) + 1 if q.numel() else 0):
            sel = q // W == k               # one entry a lane
            lanes[node[sel] * W + j[sel]] = lanes[node[sel] * W + j[sel]] + m[sel]
        lanes, off = lanes.reshape(total, W), W // 2
        while off:
            lanes = torch.cat([lanes[:, :off] + lanes[:, off:2 * off], lanes[:, off:]], dim=1)
            off //= 2
        deg = torch.clamp(lanes[:, :1].to(msgs.dtype).to(f32), min=1.0)
        out = (out.to(f32) / deg).to(msgs.dtype)
    return out.reshape(B, n_nodes, F)
