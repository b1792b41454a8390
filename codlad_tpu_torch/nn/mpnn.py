"""ProteinMPNN-style kNN graph blocks with adaLN timestep conditioning.

Counterpart of codlad_tpu/nn/mpnn.py on the Stage-2 paths: the C-alpha
featurizer (`CAProteinFeatures`, with `augment_eps` and the
sequence-sharded mode, `seq=`), the split message
chain in its `reduce_sum` (K1), `ln_mod` (K2, with dropout K5) and raw
per-edge (K6) modes, the encoder and decoder layers (the decoder also
masked, in explicit ops) in both adaLN gate modes:
'trunk' (the reference: the gates scale the whole trunk) and 'residual'
(DiT-style: the gates scale each branch, so a layer is the identity at
init). Neighbour gathers index the node tables directly (the JAX package's
one-hot gather operand is a TPU device and has no counterpart). Attribute names follow the flax module names, so
converted parameters load by name (convert/from_flax.py).

Dropout is on only when a layer is called with deterministic=False, as in
the JAX package. Every mask is the counter hash of `kernels.mpnn_kernels`
(`keep_bits`) keyed by an integer dropout seed, the layer's site and the
sample, never torch's global generator: the same seed gives the same masks
on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from codlad_tpu_torch.kernels.mpnn_kernels import (drop_threshold, fused_message_edge,
                                                   fused_message_edge_lnmod,
                                                   fused_message_edge_lnmod_drop,
                                                   fused_message_edge_lnmod_pdrop,
                                                   fused_message_sum, gather_rows,
                                                   keep_bits, site_seeds)
from codlad_tpu_torch.nn.layers import layer_norm, linear, raw_param


def gather_nodes(nodes, idx):
    """nodes [B, N, C], idx [B, M, K] -> [B, M, K, C]."""
    return gather_rows(nodes, idx.long())


def dropout(x, p, seeds):
    """Dropout of x [B, ...] at rate p > 0 with the counter-hash mask of the
    per-sample seeds: x / (1 - p) where kept, else 0 (flax nn.Dropout)."""
    keep = keep_bits(seeds, x[0].numel()).reshape(x.shape) >= drop_threshold(p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def modulate(x, shift, scale):
    """x [B, L, ...] modulated by per-sample shift/scale [B, H]."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return x * (1 + scale.reshape(shape)) + shift.reshape(shape)


class PositionWiseFeedForward(nn.Module):
    def __init__(self, num_in, num_hidden, num_ff, gen):
        super().__init__()
        self.Dense_0 = linear(num_in, num_ff, gen)
        self.Dense_1 = linear(num_ff, num_hidden, gen)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))  # erf gelu


class PositionalEncodings(nn.Module):
    """Relative sequence-offset one-hot -> linear (clipped at +/-32)."""

    def __init__(self, num_embeddings, gen, max_relative_feature=32):
        super().__init__()
        self.m = max_relative_feature
        self.Dense_0 = linear(2 * self.m + 2, num_embeddings, gen, init="lecun")

    def forward(self, offset, mask):
        m = self.m
        d = torch.clamp(offset + m, 0, 2 * m) * mask + (1 - mask) * (2 * m + 1)
        return self.Dense_0(F.one_hot(d.long(), 2 * m + 2).to(self.Dense_0.weight.dtype))


def _normalize(v, eps=1e-8):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _quaternions(Rm):
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4]."""
    diag = torch.diagonal(Rm, dim1=-2, dim2=-1)
    Rxx, Ryy, Rzz = diag.unbind(-1)
    magnitudes = 0.5 * torch.sqrt(torch.abs(1 + torch.stack(
        [Rxx - Ryy - Rzz, -Rxx + Ryy - Rzz, -Rxx - Ryy + Rzz], dim=-1)))
    signs = torch.sign(torch.stack([
        Rm[..., 2, 1] - Rm[..., 1, 2],
        Rm[..., 0, 2] - Rm[..., 2, 0],
        Rm[..., 1, 0] - Rm[..., 0, 1],
    ], dim=-1))
    xyz = signs * magnitudes
    w = torch.sqrt(F.relu(1 + diag.sum(-1, keepdim=True))) / 2.0
    q = torch.cat([xyz, w], dim=-1)
    # degenerate frames can give q == 0
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def _frames(X):
    """Per-node local frames O [B, L, 9] from the C-alpha chain."""
    dX = X[:, 1:, :] - X[:, :-1, :]
    dX_norm = torch.linalg.norm(dX, dim=-1)
    dX_mask = ((3.6 < dX_norm) & (dX_norm < 4.0)).to(X.dtype)
    U = _normalize(dX * dX_mask[..., None])
    u_2, u_1 = U[:, :-2], U[:, 1:-1]
    n_2 = _normalize(torch.cross(u_2, u_1, dim=-1))
    o_1 = _normalize(u_2 - u_1)
    O = torch.stack([o_1, n_2, torch.cross(o_1, n_2, dim=-1)], dim=2)
    O = O.reshape(O.shape[0], O.shape[1], 9)
    return F.pad(O, (0, 0, 1, 2))


class CAProteinFeatures(nn.Module):
    """C-alpha-only structure featurizer -> (edge embeddings, kNN indices).

    E_idx comes from a stable ascending sort of the adjusted distances, so
    ties (every padded column sits at the row's maximum) keep the lower
    index first, as `jax.lax.top_k` does. With augment_eps > 0 the
    coordinates get augment_eps * `noise` (N(0, 1), [B, L, 3]) when the
    caller passes one, as the JAX featurizer adds its draw when given a key."""

    n_rbf_sets, n_orient = 9, 7     # RBF sets; direction + quaternion features

    def __init__(self, edge_features, gen, num_positional_embeddings=16,
                 num_rbf=16, top_k=30, augment_eps=0.0):
        super().__init__()
        self.num_rbf = num_rbf
        self.top_k = top_k
        self.augment_eps = augment_eps
        self.PositionalEncodings_0 = PositionalEncodings(num_positional_embeddings, gen)
        edge_in = num_positional_embeddings + self.n_rbf_sets * num_rbf + self.n_orient
        self.Dense_0 = linear(edge_in, edge_features, gen, bias=False, init="lecun")
        self.LayerNorm_0 = nn.LayerNorm(edge_features, eps=1e-6)

    def _dist(self, X, mask):
        mask_2d = mask[:, None, :] * mask[:, :, None]
        dX = X[:, None, :, :] - X[:, :, None, :]
        D = mask_2d * torch.sqrt(torch.sum(dX ** 2, dim=-1) + 1e-6)
        D_max = D.max(dim=-1, keepdim=True).values
        D_adjust = D + (1.0 - mask_2d) * D_max
        k = min(self.top_k, X.shape[1])
        vals, E_idx = torch.sort(D_adjust, dim=-1, stable=True)
        return vals[..., :k], E_idx[..., :k]

    def _rbf(self, D):
        mu = torch.as_tensor(np.linspace(2.0, 22.0, self.num_rbf), dtype=D.dtype,
                             device=D.device)
        sigma = (22.0 - 2.0) / self.num_rbf
        return torch.exp(-(((D[..., None] - mu) / sigma) ** 2))

    def _get_rbf(self, A, B, idx):
        Bn = gather_nodes(B, idx)
        D = torch.sqrt(torch.sum((A[:, :, None, :] - Bn) ** 2, dim=-1) + 1e-6)
        return self._rbf(D)

    @staticmethod
    def _orient_edges(X_rows, O_rows, X_full, O_full, idx):
        """Direction and quaternion features of the rows' edges, the
        neighbours' frames and coordinates gathered from the full tables."""
        B, L, K = idx.shape
        On = gather_nodes(O_full, idx).reshape(B, L, K, 3, 3)
        dXn = gather_nodes(X_full, idx) - X_rows[:, :, None, :]
        Om = O_rows.reshape(B, L, 3, 3)
        dU = _normalize(torch.einsum("blij,blkj->blki", Om, dXn))
        Q = _quaternions(torch.einsum("blji,blkjm->blkim", Om, On))
        return torch.cat([dU, Q], dim=-1)

    def forward(self, Ca, mask, residue_idx, chain_labels, noise=None, seq=None):
        """seq (parallel/sequence.SeqGroup): the sequence-sharded mode. Ca,
        mask, residue_idx (GLOBAL positions) and chain_labels hold this
        rank's rows; the kNN is ring-streamed, the per-node tables
        all-gathered, and E_idx holds global indices."""
        if self.augment_eps > 0 and noise is not None:
            Ca = Ca + self.augment_eps * noise.to(Ca.dtype)
        if seq is None:
            D_neighbors, E_idx = self._dist(Ca, mask)
            Ca_full, res_full, chain_full = Ca, residue_idx, chain_labels
            loc = lambda table: table
        else:
            from codlad_tpu_torch.parallel.sequence import local_rows, ring_knn, seq_all_gather
            D_neighbors, E_idx = ring_knn(Ca, mask, min(self.top_k, Ca.shape[1] * seq.size),
                                          seq)
            Ca_full = seq_all_gather(Ca, seq)
            res_full = seq_all_gather(residue_idx, seq)
            chain_full = seq_all_gather(chain_labels, seq)
            loc = lambda table: local_rows(table, seq)
        Ca_0 = F.pad(Ca_full[:, :-1], (0, 0, 1, 0))
        Ca_1 = Ca_full
        Ca_2 = F.pad(Ca_full[:, 1:], (0, 0, 0, 1))
        O_full = _frames(Ca_full)
        O_features = self._orient_edges(loc(Ca_full), loc(O_full), Ca_full, O_full, E_idx)

        rbf_all = [self._rbf(D_neighbors)]
        for A, Bc in [(Ca_0, Ca_0), (Ca_2, Ca_2), (Ca_0, Ca_1), (Ca_0, Ca_2),
                      (Ca_1, Ca_0), (Ca_1, Ca_2), (Ca_2, Ca_0), (Ca_2, Ca_1)]:
            rbf_all.append(self._get_rbf(loc(A), Bc, E_idx))
        rbf_all = torch.cat(rbf_all, dim=-1)

        offset = residue_idx[:, :, None] - gather_nodes(
            res_full[..., None].to(torch.float32), E_idx)[..., 0].to(residue_idx.dtype)
        E_chains = (gather_nodes(chain_full[..., None], E_idx)[..., 0]
                    == chain_labels[:, :, None]).to(torch.int32)
        E_positional = self.PositionalEncodings_0(offset, E_chains)
        E = torch.cat([E_positional, rbf_all, O_features], dim=-1).to(Ca.dtype)
        return self.LayerNorm_0(self.Dense_0(E)), E_idx


class ProteinFeatures(CAProteinFeatures):
    """Full-backbone featurizer (the counterpart of codlad_tpu/nn/mpnn.py
    `ProteinFeatures`; reference models/protein_mpnn_utils.py:526-621): X
    [B, L, 4, 3] (N, CA, C, O) plus a virtual C-beta, 25 RBF sets over the
    ordered atom pairs, relative positional encodings; the kNN graph on the
    C-alpha distances with CAProteinFeatures' padding (the row's largest
    distance) and tie rule. -> (E, E_idx). With augment_eps > 0, X gets
    augment_eps * `noise` ([B, L, 4, 3]) where the caller passes one."""

    n_rbf_sets, n_orient = 25, 0

    def forward(self, X, mask, residue_idx, chain_labels, noise=None):
        if self.augment_eps > 0 and noise is not None:
            X = X + self.augment_eps * noise.to(X.dtype)
        N, Ca, C, O = X.unbind(2)
        # the virtual C-beta of ideal backbone geometry (reference :542-546)
        b, c = Ca - N, C - Ca
        a = torch.cross(b, c, dim=-1)
        Cb = -0.58273431 * a + 0.56802827 * b - 0.54067466 * c + Ca
        _, E_idx = self._dist(Ca, mask)
        atoms = [Ca, N, C, O, Cb]
        rbf_all = torch.cat([self._get_rbf(A, B_at, E_idx) for A in atoms for B_at in atoms],
                            dim=-1)
        offset = residue_idx[:, :, None] - gather_nodes(
            residue_idx[..., None].to(torch.float32), E_idx)[..., 0].to(residue_idx.dtype)
        E_chains = (gather_nodes(chain_labels[..., None], E_idx)[..., 0]
                    == chain_labels[:, :, None]).to(torch.int32)
        E_positional = self.PositionalEncodings_0(offset, E_chains)
        E = torch.cat([E_positional, rbf_all], dim=-1).to(X.dtype)
        return self.LayerNorm_0(self.Dense_0(E)), E_idx


class SplitMessageChain(nn.Module):
    """The MPNN message MLP W3(gelu(W2(gelu(W1(cat[self, edge, nbr]))))) with
    W1 split by input block: the self and neighbour blocks are transformed
    per node (A = Dense_0(self), Gn = Dense_1(nbr)), the edge block per edge
    inside the kernel (W_e). reduce_sum=True runs K1 (masked K-sum / scale);
    otherwise `ln_mod=(sh, sc, g)` runs K2 (residual LayerNorm + adaLN), or
    K5 with dropout on the message: `keep` [B, L, K, H] scales, or
    `pdrop=(seeds [B] int32, p)` with the mask made in the kernel; without
    `ln_mod`, K6 returns the raw per-edge messages [B, L, K, H]."""

    def __init__(self, num_hidden, self_dim, nbr_dim, edge_dim, gen,
                 reduce_sum=False, scale=30.0):
        super().__init__()
        H = num_hidden
        self.reduce_sum = reduce_sum
        self.scale = scale
        self.Dense_0 = linear(self_dim, H, gen)
        self.Dense_1 = linear(nbr_dim, H, gen, bias=False, init="xavier")
        self.W_e = raw_param((edge_dim, H), gen)
        self.W2 = raw_param((H, H), gen)
        self.b2 = raw_param((H,), gen, init="uniform", fan_in=H)
        self.W3 = raw_param((H, H), gen)
        self.b3 = raw_param((H,), gen, init="uniform", fan_in=H)

    def components(self, h_self, nbr_node_pre):
        """(A [B, L, H], Gn [B, N, H], W_e, W2, b2, W3, b3)."""
        return (self.Dense_0(h_self), self.Dense_1(nbr_node_pre), self.W_e,
                self.W2, self.b2, self.W3, self.b3)

    def forward(self, h_self, edge_pre, nbr_node_pre, idx, mask_attend=None,
                ln_mod=None, keep=None, pdrop=None):
        A, Gn, W_e, W2, b2, W3, b3 = self.components(h_self, nbr_node_pre)
        if self.reduce_sum:
            if mask_attend is None:
                mask_attend = torch.ones(idx.shape, dtype=A.dtype, device=A.device)
            return fused_message_sum(A, edge_pre, Gn, idx, mask_attend, W_e, W2,
                                     b2, W3, b3, self.scale)
        if ln_mod is None:
            return fused_message_edge(A, edge_pre, Gn, idx, W_e, W2, b2, W3, b3)
        sh, sc, g = ln_mod
        if pdrop is not None:
            seeds, p = pdrop
            return fused_message_edge_lnmod_pdrop(A, edge_pre, Gn, idx, W_e, W2, b2,
                                                  W3, b3, sh, sc, g, seeds, p)
        if keep is not None:
            return fused_message_edge_lnmod_drop(A, edge_pre, Gn, idx, W_e, W2, b2,
                                                 W3, b3, sh, sc, g, keep)
        return fused_message_edge_lnmod(A, edge_pre, Gn, idx, W_e, W2, b2, W3,
                                        b3, sh, sc, g)


GATE_MODES = ("trunk", "residual")


class _DropoutLayer(nn.Module):
    """Dropout rate, seed sites and adaLN gate mode shared by the encoder and
    decoder layers: site + 0 and + 1 drop the node update's dh and dh2, site
    + 2 the encoder's edge message."""

    def __init__(self, dropout, site, gate_mode):
        super().__init__()
        if gate_mode not in GATE_MODES:
            raise ValueError(f"gate_mode must be one of {GATE_MODES}, not {gate_mode!r}")
        self.dropout = dropout
        self.site = site
        self.gate_mode = gate_mode

    def _seeds(self, deterministic, seed, offset, batch, device):
        """Seeds of one dropout site, or None when dropout is off."""
        if deterministic or self.dropout <= 0.0:
            return None
        if seed is None:
            raise ValueError("dropout (deterministic=False) needs a dropout seed")
        return site_seeds(seed, self.site + offset, batch, device)

    def _site_seeds(self, deterministic, seed, n, batch, device):
        """Seeds of sites + 0 .. n - 1, taken before the layer queues any work:
        each is copied from host memory, which waits for the device's queue."""
        return [self._seeds(deterministic, seed, o, batch, device) for o in range(n)]

    def _drop(self, x, seeds):
        """x through the dropout of one site's seeds (x itself when None)."""
        return x if seeds is None else dropout(x, self.dropout, seeds)


def _node_epilogue(layer, h_V, dh, sh1, sc1, g1, sh2, sc2, g2, mask_V,
                   deterministic=True, seed=None):
    """Trunk-mode h_V update from a node-message sum: LN -> modulate/gate
    -> PFF -> LN -> modulate/gate -> mask, with dropout on dh and dh2."""
    s1, s2 = layer._site_seeds(deterministic, seed, 2, h_V.shape[0], h_V.device)
    h_V = layer_norm(h_V + layer._drop(dh.to(h_V.dtype), s1))
    h_V = g1[:, None, :] * modulate(h_V, sh1, sc1)
    h_V = layer_norm(h_V + layer._drop(layer.PositionWiseFeedForward_0(h_V), s2))
    h_V = g2[:, None, :] * modulate(h_V, sh2, sc2)
    if mask_V is not None:
        h_V = mask_V[..., None] * h_V
    return h_V


def _residual_update(layer, h_V, dh, g1, sh2, sc2, g2, mask_V, s1, s2):
    """Residual-mode h_V update from a node-message sum: the gates scale the
    branches, h_V + g1 * dh, then + g2 * PFF(modulate(LN(h_V))) -> mask,
    with dropout on dh and the PFF output (seeds s1, s2, or None)."""
    h_V = h_V + g1[:, None, :] * layer._drop(dh.to(h_V.dtype), s1)
    x = modulate(layer_norm(h_V), sh2, sc2)
    h_V = h_V + g2[:, None, :] * layer._drop(layer.PositionWiseFeedForward_0(x), s2)
    if mask_V is not None:
        h_V = mask_V[..., None] * h_V
    return h_V


class EncLayerDiffusion(_DropoutLayer):
    """Encoder layer with 9-way adaLN modulation from the timestep embedding.
    Trunk mode: node update through K1, edge update through K2 (K5 when
    dropout is on). Residual mode (codlad_tpu/nn/mpnn.py:453-467): node
    update through K1 on modulate(LN(h_V)), edge update h_E + g3 * dropout(K6
    of modulate(LN(h_E)))."""

    def __init__(self, num_hidden, gen, scale=30.0, dropout=0.1, site=0,
                 gate_mode="trunk"):
        super().__init__(dropout, site, gate_mode)
        H = num_hidden
        self.Dense_0 = linear(H, 9 * H, gen, init="zeros")
        self.SplitMessageChain_0 = SplitMessageChain(H, H, H, H, gen,
                                                     reduce_sum=True, scale=scale)
        self.PositionWiseFeedForward_0 = PositionWiseFeedForward(H, H, 4 * H, gen)
        self.SplitMessageChain_1 = SplitMessageChain(H, H, H, H, gen)

    def mods(self, c):
        """The 9-way adaLN modulation splits for one conditioning batch."""
        return self.Dense_0(F.silu(c)).chunk(9, dim=-1)

    def forward(self, h_V, h_E, idx, mask_V, mask_attend, c, deterministic=True,
                seed=None, seq=None):
        """seq (parallel/sequence.SeqGroup): the rows are this rank's, and
        the chains gather neighbour state from the all-gathered node table
        (Gn of N = L x seq.size rows)."""
        sh1, sc1, g1, sh2, sc2, g2, sh3, sc3, g3 = self.mods(c)
        if seq is None:
            tbl = lambda v: v
        else:
            from codlad_tpu_torch.parallel.sequence import seq_all_gather
            tbl = lambda v: seq_all_gather(v, seq)
        if self.gate_mode == "residual":
            s1, s2, s3 = self._site_seeds(deterministic, seed, 3, h_V.shape[0], h_V.device)
            x = modulate(layer_norm(h_V), sh1, sc1)
            dh = self.SplitMessageChain_0(x, h_E, tbl(x), idx, mask_attend=mask_attend)
            h_V = _residual_update(self, h_V, dh, g1, sh2, sc2, g2, mask_V, s1, s2)
            xe = modulate(layer_norm(h_E), sh3, sc3)
            msg = self.SplitMessageChain_1(h_V, xe, tbl(h_V), idx)
            h_E = h_E + g3[:, None, None, :] * self._drop(msg.to(h_E.dtype), s3)
            return h_V, h_E
        dh = self.SplitMessageChain_0(h_V, h_E, tbl(h_V), idx, mask_attend=mask_attend)
        h_V = _node_epilogue(self, h_V, dh, sh1, sc1, g1, sh2, sc2, g2, mask_V,
                             deterministic, seed)
        seeds = self._seeds(deterministic, seed, 2, h_V.shape[0], h_V.device)
        pdrop = None if seeds is None else (seeds, self.dropout)
        h_E = self.SplitMessageChain_1(h_V, h_E, tbl(h_V), idx, ln_mod=(sh3, sc3, g3),
                                       pdrop=pdrop)
        return h_V, h_E


class DecLayerDiffusion(_DropoutLayer):
    """Decoder layer with 6-way adaLN modulation. Unmasked (production): the
    message input cat[h_V, edge, s_nbr, v_nbr] in split form -- node blocks
    s_node and v_node are concatenated into one Dense, the edge block (2*h_E)
    enters through W_e scaled by `edge_scale` -- summed by K1. In residual
    mode (codlad_tpu/nn/mpnn.py:559-595) the chain's self input is
    modulate(LN(h_V)); s_node and v_node come as the caller gives them.

    masked=True (the `decoder_mask` configuration, codlad_tpu/nn/mpnn.py:
    521-527, 574-588): the per-edge blocks edge_pre, s_node and v_node
    [B, L, K, H] arrive already masked, and the message
    Dense_5(gelu(Dense_6(gelu(Dense_3(h_V) + Dense_4(edge) + Dense_1(s) +
    Dense_2(v))))) (erf gelu, as flax's) is summed over K / scale in
    explicit ops: no kernel."""

    def __init__(self, num_hidden, gen, scale=30.0, dropout=0.1, site=0,
                 gate_mode="trunk", masked=False):
        super().__init__(dropout, site, gate_mode)
        H = num_hidden
        self.masked = masked
        self.scale = scale
        self.Dense_0 = linear(H, 6 * H, gen, init="zeros")
        self.PositionWiseFeedForward_0 = PositionWiseFeedForward(H, H, 4 * H, gen)
        if masked:
            self.Dense_1 = linear(H, H, gen, bias=False, init="xavier")
            self.Dense_2 = linear(H, H, gen, bias=False, init="xavier")
            self.Dense_3 = linear(H, H, gen)
            self.Dense_4 = linear(H, H, gen, bias=False, init="xavier")
            self.Dense_5 = linear(H, H, gen)
            self.Dense_6 = linear(H, H, gen)
        else:
            self.SplitMessageChain_0 = SplitMessageChain(H, H, 2 * H, H, gen,
                                                         reduce_sum=True, scale=scale)

    def mods(self, c):
        """The 6-way adaLN modulation splits for one conditioning batch."""
        return self.Dense_0(F.silu(c)).chunk(6, dim=-1)

    def chain_operands(self, h_self, s_node, v_node, edge_scale=1.0):
        """K1's operands (A, Gn, W_e, W2, b2, W3, b3) with the node blocks
        concatenated and `edge_scale` folded into W_e."""
        A, Gn, W_e, W2, b2, W3, b3 = self.SplitMessageChain_0.components(
            h_self, torch.cat([s_node, v_node], dim=-1))
        if edge_scale != 1.0:
            W_e = W_e * edge_scale
        return A, Gn, W_e, W2, b2, W3, b3

    def _masked_message_sum(self, h_self, edge_pre, s_edge, v_edge):
        pre = (self.Dense_3(h_self)[:, :, None, :] + self.Dense_4(edge_pre)
               + self.Dense_1(s_edge) + self.Dense_2(v_edge))
        msg = self.Dense_5(F.gelu(self.Dense_6(F.gelu(pre))))
        return msg.sum(dim=-2) / self.scale

    def forward(self, h_V, idx, edge_pre, s_node, v_node, mask_V, c,
                edge_scale=1.0, deterministic=True, seed=None):
        sh1, sc1, g1, sh2, sc2, g2 = self.mods(c)
        residual = self.gate_mode == "residual"
        if residual:
            s1, s2 = self._site_seeds(deterministic, seed, 2, h_V.shape[0], h_V.device)
        x = modulate(layer_norm(h_V), sh1, sc1) if residual else h_V
        if self.masked:
            dh = self._masked_message_sum(x, edge_pre, s_node, v_node)
        else:
            A, Gn, W_e, W2, b2, W3, b3 = self.chain_operands(x, s_node, v_node, edge_scale)
            ones = torch.ones(idx.shape, dtype=A.dtype, device=A.device)
            dh = fused_message_sum(A, edge_pre, Gn, idx, ones, W_e, W2, b2, W3, b3,
                                   self.SplitMessageChain_0.scale)
        if residual:
            return _residual_update(self, h_V, dh, g1, sh2, sc2, g2, mask_V, s1, s2)
        return _node_epilogue(self, h_V, dh, sh1, sc1, g1, sh2, sc2, g2, mask_V,
                              deterministic, seed)
