"""Autoregressive ProteinMPNN: graph-conditioned sequence design.

Counterpart of codlad_tpu/models/protein_mpnn.py (reference
models/protein_mpnn_utils.py:119-205 `EncLayer` / `DecLayer`, :624-988
`ProteinMPNN` with `sample`, `tied_sample`, `conditional_probs`,
`unconditional_probs`). The CODLAD pipeline never calls it; it is part of
the reference's component surface. Everything here is dense layers, erf
gelu and LayerNorm (eps 1e-6, flax's default), as in the JAX package,
which runs it outside any Pallas kernel; here it is plain PyTorch.

As in the JAX package, the decoding order's attention masks come from a
rank comparison (`order_attend_masks`: the inverse permutation, O(B L²))
instead of the reference's one-hot triangular einsum, and
`conditional_probs` computes every position, zeroing those with
chain_M * mask == 0. JAX's `lax.scan`s over decode steps or tied groups
are plain loops here, writing each decoded row in place.

Randomness is injected: the decoding order comes from the caller's
`randn` [B, L]; a draw is argmax(log p + g) (`jax.random.categorical`)
with g the Gumbel noise of that step, `noise` [steps, B, V] when the
caller passes it, else drawn from the torch.Generator `generator`. Dropout
(deterministic=False) draws its masks from `generator` too. The modules
carry the flax names (`features`, `W_e`, `W_s`, `enc_i`, `dec_i`, `W_out`;
`W1`..`W13`, `norm1`..`norm3`, `dense`), so convert/from_flax.load_flax
fills them from JAX parameters.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from codlad_tpu_torch.nn.layers import embedding, linear
from codlad_tpu_torch.nn.mpnn import (CAProteinFeatures, PositionWiseFeedForward,
                                      ProteinFeatures, gather_nodes)


def cat_neighbors_nodes(h_nodes, h_neighbors, E_idx):
    return torch.cat([h_neighbors, gather_nodes(h_nodes, E_idx)], dim=-1)


def _dropout(x, p, generator):
    """flax nn.Dropout at rate p with a mask from `generator` (None: off)."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _message(layer, h_V, h_context, prefix=""):
    """W3(gelu(W2(gelu(W1(cat[h_V, context]))))) per edge (erf gelu)."""
    W1, W2, W3 = (getattr(layer, f"W{prefix}{i}") for i in (1, 2, 3))
    h = torch.cat([h_V[:, :, None, :].expand(-1, -1, h_context.shape[2], -1), h_context], -1)
    return W3(F.gelu(W2(F.gelu(W1(h)))))


class _Layer(nn.Module):
    def __init__(self, num_hidden, num_in, gen, dropout=0.1, scale=30.0):
        super().__init__()
        h = num_hidden
        self.dropout, self.scale = dropout, scale
        self.W1 = linear(h + num_in, h, gen)
        self.W2 = linear(h, h, gen)
        self.W3 = linear(h, h, gen)
        self.norm1 = nn.LayerNorm(h, eps=1e-6)
        self.norm2 = nn.LayerNorm(h, eps=1e-6)
        self.dense = PositionWiseFeedForward(h, h, h * 4, gen)

    def _node_update(self, h_V, h_context, mask_V, mask_attend, generator):
        m = _message(self, h_V, h_context)
        if mask_attend is not None:
            m = mask_attend[..., None] * m
        dh = torch.sum(m, -2) / self.scale
        h_V = self.norm1(h_V + _dropout(dh, self.dropout, generator))
        dh = self.dense(h_V)
        h_V = self.norm2(h_V + _dropout(dh, self.dropout, generator))
        if mask_V is not None:
            h_V = mask_V[..., None] * h_V
        return h_V


class EncLayer(_Layer):
    """Plain ProteinMPNN encoder layer (reference :119-165): the node message
    chain and feed-forward, then the edge update chain."""

    def __init__(self, num_hidden, num_in, gen, dropout=0.1, scale=30.0):
        super().__init__(num_hidden, num_in, gen, dropout, scale)
        h = num_hidden
        self.W11 = linear(h + num_in, h, gen)
        self.W12 = linear(h, h, gen)
        self.W13 = linear(h, h, gen)
        self.norm3 = nn.LayerNorm(h, eps=1e-6)

    def forward(self, h_V, h_E, E_idx, mask_V=None, mask_attend=None, generator=None):
        h_V = self._node_update(h_V, cat_neighbors_nodes(h_V, h_E, E_idx), mask_V, mask_attend,
                                generator)
        m = _message(self, h_V, cat_neighbors_nodes(h_V, h_E, E_idx), prefix="1")
        h_E = self.norm3(h_E + _dropout(m, self.dropout, generator))
        return h_V, h_E


class DecLayer(_Layer):
    """Plain ProteinMPNN decoder layer (reference :168-205) on the caller's
    concatenated per-edge context h_ESV."""

    def forward(self, h_V, h_ESV, mask_V=None, mask_attend=None, generator=None):
        return self._node_update(h_V, h_ESV, mask_V, mask_attend, generator)


def decoding_order_from_noise(noise_priority, randn):
    """Random decoding order, low-priority (fixed) positions first (reference
    :724-725): a stable argsort of (priority + 1e-4) * |randn|."""
    return torch.argsort((noise_priority + 0.0001) * torch.abs(randn), dim=-1, stable=True)


def order_attend_masks(decoding_order, E_idx, mask):
    """(mask_bw, mask_fw) [B, L, K, 1]: mask_bw[b, q, k] = 1 iff neighbour
    E_idx[b, q, k] decodes strictly before q, from the inverse permutation."""
    rank = torch.argsort(decoding_order, dim=-1)
    before = (rank[:, None, :] < rank[:, :, None]).to(torch.float32)
    mask_attend = torch.gather(before, 2, E_idx.long())[..., None]
    mask_1d = mask[:, :, None, None]
    return mask_1d * mask_attend, mask_1d * (1.0 - mask_attend)


class ProteinMPNN(nn.Module):
    """Graph-conditioned autoregressive sequence model (reference :624-706),
    on C-alpha traces X [B, L, 3] (ca_only, the default) or backbones
    [B, L, 4, 3]."""

    def __init__(self, gen, num_letters=21, node_features=128, edge_features=128,
                 hidden_dim=128, num_encoder_layers=3, num_decoder_layers=3, vocab=21,
                 k_neighbors=64, augment_eps=0.0, dropout=0.1, ca_only=True):
        super().__init__()
        h = hidden_dim
        self.num_letters, self.hidden_dim = num_letters, hidden_dim
        self.num_decoder_layers = num_decoder_layers
        feat = CAProteinFeatures if ca_only else ProteinFeatures
        self.features = feat(edge_features, gen, top_k=k_neighbors, augment_eps=augment_eps)
        self.W_e = linear(edge_features, h, gen)
        self.W_s = embedding(vocab, h, gen, std=1.0)
        self.encoder_layers = [EncLayer(h, h * 2, gen, dropout) for _ in range(num_encoder_layers)]
        self.decoder_layers = [DecLayer(h, h * 3, gen, dropout) for _ in range(num_decoder_layers)]
        for i, layer in enumerate(self.encoder_layers):
            self.add_module(f"enc_{i}", layer)
        for i, layer in enumerate(self.decoder_layers):
            self.add_module(f"dec_{i}", layer)
        self.W_out = linear(h, num_letters, gen)

    def encode(self, X, mask, residue_idx, chain_encoding_all, noise=None, generator=None):
        """Featurize and run the encoder stack -> (h_V, h_E, E_idx)
        (reference :664-674). noise: the featurizer's coordinate noise."""
        E, E_idx = self.features(X, mask, residue_idx, chain_encoding_all, noise=noise)
        h_V = torch.zeros(E.shape[:2] + (self.hidden_dim,), dtype=E.dtype, device=E.device)
        h_E = self.W_e(E)
        mask_attend = mask[:, :, None] * gather_nodes(mask[..., None], E_idx)[..., 0]
        for layer in self.encoder_layers:
            h_V, h_E = layer(h_V, h_E, E_idx, mask, mask_attend, generator)
        return h_V, h_E, E_idx

    def decode_parallel(self, h_V, h_E, E_idx, h_S, mask, mask_bw, mask_fw, generator=None):
        """The teacher-forced decoder -> log-probs (reference :686-705):
        positions read decoded neighbours' running state (mask_bw) and the
        frozen encoder state elsewhere (mask_fw)."""
        h_ES = cat_neighbors_nodes(h_S, h_E, E_idx)
        h_EX_encoder = cat_neighbors_nodes(torch.zeros_like(h_S), h_E, E_idx)
        h_EXV_encoder_fw = mask_fw * cat_neighbors_nodes(h_V, h_EX_encoder, E_idx)
        for layer in self.decoder_layers:
            h_ESV = mask_bw * cat_neighbors_nodes(h_V, h_ES, E_idx) + h_EXV_encoder_fw
            h_V = layer(h_V, h_ESV, mask_V=mask, generator=generator)
        return F.log_softmax(self.W_out(h_V), dim=-1)

    def forward(self, X, S, mask, chain_M, residue_idx, chain_encoding_all, randn,
                use_input_decoding_order=False, decoding_order=None, noise=None,
                deterministic=True, generator=None):
        """Teacher-forced forward -> per-position log-probs (reference
        `forward`, :662-705). Dropout when deterministic is False, its masks
        from `generator`."""
        gen = None if deterministic else generator
        if not deterministic and gen is None:
            raise ValueError("dropout (deterministic=False) needs a generator")
        h_V, h_E, E_idx = self.encode(X, mask, residue_idx, chain_encoding_all, noise, gen)
        chain_M = chain_M * mask
        if not use_input_decoding_order:
            decoding_order = decoding_order_from_noise(chain_M, randn)
        mask_bw, mask_fw = order_attend_masks(decoding_order, E_idx, mask)
        return self.decode_parallel(h_V, h_E, E_idx, self.W_s(S), mask, mask_bw, mask_fw, gen)

    def unconditional_probs(self, X, mask, residue_idx, chain_encoding_all):
        """Log-probs with no sequence context: every position reads only the
        frozen encoder state (reference :959-988)."""
        h_V, h_E, E_idx = self.encode(X, mask, residue_idx, chain_encoding_all)
        h_EX_encoder = cat_neighbors_nodes(torch.zeros_like(h_V), h_E, E_idx)
        h_EXV_encoder_fw = mask[:, :, None, None] * cat_neighbors_nodes(h_V, h_EX_encoder, E_idx)
        for layer in self.decoder_layers:
            h_V = layer(h_V, h_EXV_encoder_fw, mask_V=mask)
        return F.log_softmax(self.W_out(h_V), dim=-1)


def _adjusted_probs(logits, temperature, omit_AAs, bias_AAs, bias_by_res_t, pssm=None,
                    omit_AA_mask_t=None):
    """Sampling-time adjustments (reference :771-786): hard omits, global and
    per-residue biases, PSSM mixing (pssm = (coef, bias, multi,
    log_odds_mask), each None when off), per-position omits."""
    logits = logits / temperature
    probs = F.softmax(logits - omit_AAs[None, :] * 1e8 + bias_AAs[None, :] / temperature
                      + bias_by_res_t / temperature, dim=-1)
    if pssm is not None:
        coef, bias, multi, log_odds_mask = pssm
        if coef is not None:
            w = multi * coef[:, None]
            probs = (1.0 - w) * probs + w * bias
        if log_odds_mask is not None:
            pm = probs * log_odds_mask + probs * 0.001
            probs = pm / torch.sum(pm, dim=-1, keepdim=True)
    if omit_AA_mask_t is not None:
        pm = probs * (1.0 - omit_AA_mask_t)
        probs = pm / torch.sum(pm, dim=-1, keepdim=True)
    return probs


def gumbel(shape, generator, device):
    """Gumbel noise -log(-log(u)), u uniform in [tiny, 1) from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _draw(probs, g):
    """jax.random.categorical(key, log p): argmax(log p + g)."""
    return torch.argmax(torch.log(probs) + g, dim=-1)


def _noise_of(noise, n, B, V, generator, device):
    if noise is not None:
        return noise.to(device)
    if generator is None:
        raise ValueError("sampling needs `noise` or a `generator`")
    return gumbel((n, B, V), generator, device)


def _defaults(model, B, L, device, omit_AAs, bias_AAs, bias_by_res, chain_mask, chain_M_pos):
    V = model.num_letters
    f32 = dict(dtype=torch.float32, device=device)
    omit_AAs = torch.zeros(V, **f32) if omit_AAs is None else torch.as_tensor(omit_AAs, **f32)
    bias_AAs = torch.zeros(V, **f32) if bias_AAs is None else torch.as_tensor(bias_AAs, **f32)
    bias_by_res = torch.zeros((B, L, V), **f32) if bias_by_res is None else bias_by_res
    chain_M_pos = torch.ones_like(chain_mask) if chain_M_pos is None else chain_M_pos
    return omit_AAs, bias_AAs, bias_by_res, chain_M_pos


def _decode_rows(model, rows, t, h_S, h_E, E_idx, h_EXV_fw, mask_bw, mask, h_V_stack):
    """Run every decoder layer on the rows t [B] (one position a sample),
    writing each layer's output into h_V_stack; -> the last layer's logits
    [B, V]."""
    E_idx_t, h_E_t = E_idx[rows, t][:, None], h_E[rows, t][:, None]
    h_EXV_t, mask_bw_t = h_EXV_fw[rows, t][:, None], mask_bw[rows, t][:, None]
    mask_t = mask[rows, t][:, None]
    h_ES_t = cat_neighbors_nodes(h_S, h_E_t, E_idx_t)
    for l, layer in enumerate(model.decoder_layers):
        h_ESV_t = mask_bw_t * cat_neighbors_nodes(h_V_stack[l], h_ES_t, E_idx_t) + h_EXV_t
        h_V_stack[l + 1][rows, t] = layer(h_V_stack[l][rows, t][:, None], h_ESV_t,
                                          mask_V=mask_t)[:, 0]
    return model.W_out(h_V_stack[-1][rows, t])


def _decoder_inputs(model, X, mask, residue_idx, chain_encoding_all, decoding_order):
    h_V, h_E, E_idx = model.encode(X, mask, residue_idx, chain_encoding_all)
    mask_bw, mask_fw = order_attend_masks(decoding_order, E_idx, mask)
    h_EX_encoder = cat_neighbors_nodes(torch.zeros_like(h_V), h_E, E_idx)
    h_EXV_fw = mask_fw * cat_neighbors_nodes(h_V, h_EX_encoder, E_idx)
    h_V_stack = [h_V] + [torch.zeros_like(h_V) for _ in range(model.num_decoder_layers)]
    return h_E, E_idx, mask_bw, h_EXV_fw, h_V_stack


@torch.no_grad()
def sample(model, X, randn, S_true, chain_mask, chain_encoding_all, residue_idx, mask,
           temperature=1.0, omit_AAs=None, bias_AAs=None, chain_M_pos=None, omit_AA_mask=None,
           bias_by_res=None, pssm_coef=None, pssm_bias=None, pssm_multi=0.0,
           pssm_log_odds_flag=False, pssm_log_odds_mask=None, pssm_bias_flag=False,
           noise=None, generator=None):
    """Autoregressive sampling (reference `sample`, :709-801), one decode step
    a position in the order that `randn` [B, L] gives. noise: the Gumbel
    noise of each step [L, B, V], else drawn from `generator`.

    Returns {"S", "probs", "decoding_order"}; positions with chain_mask *
    chain_M_pos * mask == 0 keep S_true and zero probs (reference
    :790-792)."""
    B, L = X.shape[0], X.shape[1]
    V, dev = model.num_letters, X.device
    omit_AAs, bias_AAs, bias_by_res, chain_M_pos = _defaults(
        model, B, L, dev, omit_AAs, bias_AAs, bias_by_res, chain_mask, chain_M_pos)
    noise = _noise_of(noise, L, B, V, generator, dev)
    chain_mask = chain_mask * chain_M_pos * mask
    decoding_order = decoding_order_from_noise(chain_mask, randn)
    h_E, E_idx, mask_bw, h_EXV_fw, h_V_stack = _decoder_inputs(
        model, X, mask, residue_idx, chain_encoding_all, decoding_order)
    pssm = None
    if pssm_bias_flag or pssm_log_odds_flag:
        pssm = (pssm_coef if pssm_bias_flag else None, pssm_bias if pssm_bias_flag else None,
                pssm_multi, pssm_log_odds_mask if pssm_log_odds_flag else None)

    rows = torch.arange(B, device=dev)
    h_S = torch.zeros_like(h_V_stack[0])
    S = torch.zeros((B, L), dtype=S_true.dtype, device=dev)
    all_probs = torch.zeros((B, L, V), dtype=torch.float32, device=dev)
    for step in range(L):
        t = decoding_order[:, step]
        logits = _decode_rows(model, rows, t, h_S, h_E, E_idx, h_EXV_fw, mask_bw, mask, h_V_stack)
        pssm_t = None
        if pssm is not None:
            coef, pbias, multi, lom = pssm
            pssm_t = (None if coef is None else coef[rows, t],
                      None if pbias is None else pbias[rows, t], multi,
                      None if lom is None else lom[rows, t])
        probs = _adjusted_probs(logits, temperature, omit_AAs, bias_AAs, bias_by_res[rows, t],
                                pssm=pssm_t,
                                omit_AA_mask_t=None if omit_AA_mask is None
                                else omit_AA_mask[rows, t])
        cm_t = chain_mask[rows, t]
        S_t = torch.where(cm_t > 0, _draw(probs, noise[step]), S_true[rows, t]).to(S_true.dtype)
        all_probs[rows, t] = cm_t[:, None] * probs
        h_S[rows, t] = model.W_s(S_t)
        S[rows, t] = S_t
    return {"S": S, "probs": all_probs, "decoding_order": decoding_order}


def build_tied_groups(decoding_order_row, tied_pos, L):
    """Groups for tied sampling (reference :815-824), on the host: walk the
    decoding order; the first member of a tied set met pulls the whole set
    in as one group. -> (groups [G, Gmax] int32, -1 padded; the flat
    decoding order [L])."""
    seen, groups, tied_lookup = set(), [], {}
    for s in tied_pos or []:
        for p in s:
            tied_lookup[int(p)] = [int(q) for q in s]
    for t in np.asarray(decoding_order_row).tolist():
        if t in seen:
            continue
        grp = tied_lookup.get(t, [t])
        groups.append(grp)
        seen.update(grp)
    gmax = max(len(g) for g in groups)
    padded = np.full((len(groups), gmax), -1, dtype=np.int32)
    for i, g in enumerate(groups):
        padded[i, :len(g)] = g
    return padded, np.concatenate([np.asarray(g, np.int32) for g in groups])


@torch.no_grad()
def tied_sample(model, X, randn, S_true, chain_mask, chain_encoding_all, residue_idx, mask,
                tied_pos, tied_beta=None, temperature=1.0, omit_AAs=None, bias_AAs=None,
                chain_M_pos=None, omit_AA_mask=None, bias_by_res=None, noise=None,
                generator=None):
    """Tied-position sampling (reference `tied_sample`, :804-895): a tied set
    decodes as one group, its members' logits averaged (weighted by
    tied_beta), one draw written to every member. The groups follow batch
    element 0's decoding order for the whole batch (reference :816), built
    on the host from `randn`. noise: the Gumbel noise of each group
    [G, B, V] (G = the number of groups), else drawn from `generator`."""
    B, L = X.shape[0], X.shape[1]
    V, dev = model.num_letters, X.device
    omit_AAs, bias_AAs, bias_by_res, chain_M_pos = _defaults(
        model, B, L, dev, omit_AAs, bias_AAs, bias_by_res, chain_mask, chain_M_pos)
    tied_beta = (torch.ones(L, device=dev) if tied_beta is None
                 else torch.as_tensor(np.asarray(tied_beta, np.float32), device=dev))
    chain_mask = chain_mask * chain_M_pos * mask
    order_row = np.argsort((chain_mask[0].cpu().numpy() + 0.0001)
                           * np.abs(np.asarray(torch.as_tensor(randn)[0].cpu())))
    groups, flat_order = build_tied_groups(order_row, tied_pos, L)
    noise = _noise_of(noise, len(groups), B, V, generator, dev)
    decoding_order = torch.as_tensor(flat_order, dtype=torch.int64,
                                     device=dev)[None].expand(B, L)
    h_E, E_idx, mask_bw, h_EXV_fw, h_V_stack = _decoder_inputs(
        model, X, mask, residue_idx, chain_encoding_all, decoding_order)

    rows = torch.arange(B, device=dev)
    h_S = torch.zeros_like(h_V_stack[0])
    S = torch.zeros((B, L), dtype=S_true.dtype, device=dev)
    all_probs = torch.zeros((B, L, V), dtype=torch.float32, device=dev)
    for g, group in enumerate(groups):
        members = [int(p) for p in group if p >= 0]
        n_valid = float(len(members))
        logits_sum = torch.zeros((B, V), dtype=torch.float32, device=dev)
        bias_sum = torch.zeros((B, V), dtype=torch.float32, device=dev)
        for p in members:
            t = torch.full((B,), p, dtype=torch.int64, device=dev)
            lg = _decode_rows(model, rows, t, h_S, h_E, E_idx, h_EXV_fw, mask_bw, mask, h_V_stack)
            logits_sum = logits_sum + tied_beta[p] * (lg / temperature) / n_valid
            bias_sum = bias_sum + bias_by_res[:, p] / n_valid
        probs = F.softmax(logits_sum - omit_AAs[None, :] * 1e8 + bias_AAs[None, :] / temperature
                          + bias_sum / temperature, dim=-1)
        if omit_AA_mask is not None:
            pm = probs * (1.0 - omit_AA_mask[:, members[0]])
            probs = pm / torch.sum(pm, dim=-1, keepdim=True)
        S_samp = _draw(probs, noise[g])
        for p in members:
            S_t = torch.where(chain_mask[:, p] > 0, S_samp, S_true[:, p]).to(S_true.dtype)
            h_S[:, p] = model.W_s(S_t)
            S[:, p] = S_t
            all_probs[:, p] = mask[:, p, None] * probs
    return {"S": S, "probs": all_probs, "decoding_order": decoding_order}


@torch.no_grad()
def conditional_probs(model, X, S, mask, chain_M, residue_idx, chain_encoding_all, randn,
                      backbone_only=False):
    """Per-position conditionals (reference `conditional_probs`, :897-956):
    for each position, the teacher-forced decoder with a decoding order that
    puts it last (backbone_only=False: it reads every other position's
    true S) or first (backbone_only=True: it reads the backbone only).
    Positions with chain_M * mask == 0 give zeros, per sample. -> [B, L, V]."""
    B, L = X.shape[0], X.shape[1]
    h_V, h_E, E_idx = model.encode(X, mask, residue_idx, chain_encoding_all)
    h_S = model.W_s(S)
    chain_M = chain_M * mask
    rows = []
    for idx in range(L):
        onehot = F.one_hot(torch.tensor(idx, device=X.device), L).to(torch.float32)
        order_mask = (1.0 - onehot) if backbone_only else onehot
        dec_order = decoding_order_from_noise(order_mask[None].expand(B, L), randn)
        mask_bw, mask_fw = order_attend_masks(dec_order, E_idx, mask)
        lp = model.decode_parallel(h_V, h_E, E_idx, h_S, mask, mask_bw, mask_fw)
        rows.append(lp[:, idx])
    return torch.stack(rows, 1) * chain_M[..., None]
