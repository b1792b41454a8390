"""Latent denoiser: ProteinMPNN-style kNN graph network with adaLN timestep
conditioning over per-residue latents.

Counterpart of codlad_tpu/models/denoiser.py: trunk or `residual` adaLN, `self_condition` (x_in reads cat[x_self_cond,
x], zeros when none is given), `decoder_mask` (the masked decoder, its
decoding order from a `decoding_randn` [B, L] the caller may pass),
`use_seq_in_encoder`, `final_adln` (a plain Dense head when False),
`augment_eps` (coordinate noise passed in as `augment_noise`) and `remat`.
`compute_condition` holds everything that does not depend on the noisy
latent (kNN graph, edge features, sequence embedding) and runs once per
batch; `denoise` runs at every sampling step, with `fuse_pairs=True`
through the layer-pair kernel K7. `forward` runs both, the training path:
the featurizer is then inside the graph and gets gradients, and dropout is
on when it is called with deterministic=False and a dropout seed (an
integer, or (seed, row0): the masks of rows row0.. of a larger batch, as a
data-parallel rank draws them). `forward_with_cfg` is the guided forward
over a doubled batch. Each of the three takes `seq`, a
parallel/sequence.SeqGroup: the sequence-sharded mode (JAX's `seq=`), in
which the inputs hold this rank's rows of the residues, the kNN is
ring-streamed, the node tables the message chains gather from are
all-gathered (the kernels then take a node table of N = L x seq.size rows
for L edge rows) and the output is this rank's rows; the parameters are the
dense model's.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from codlad_tpu_torch.kernels.mpnn_kernels import fused_edge_then_sum
from codlad_tpu_torch.nn.layers import FinalLayer, TimestepEmbedder, embedding, linear
from codlad_tpu_torch.nn.mpnn import (CAProteinFeatures, DecLayerDiffusion,
                                      EncLayerDiffusion, _node_epilogue, gather_nodes)


def _remat(layer, *args):
    """layer(*args) with its activations recomputed in the backward
    (torch.utils.checkpoint, non-reentrant). The layer's parameters go in as
    explicit inputs, so the recomputation, which runs after a caller's
    `functional_call` has restored the module, uses the same tensors and
    their grads reach them. Dropout masks are keyed by the integer seed in
    `args`, so the recomputed forward draws the same masks."""
    names = [n for n, _ in layer.named_parameters()]
    vals = [functools.reduce(getattr, n.split("."), layer) for n in names]
    n_args = len(args)

    def run(*inputs):
        return functional_call(layer, dict(zip(names, inputs[n_args:])), inputs[:n_args])

    return checkpoint(run, *args, *vals, use_reentrant=False, preserve_rng_state=False)


class MPNNDenoiser(nn.Module):
    """Defaults are the production Stage-2 configuration (`mpnn_diffusion`).
    adaln_mode: 'trunk' (the reference) or 'residual' (DiT-style branch
    gates), passed to every layer."""

    def __init__(self, gen, hidden_dim=128, edge_features=128,
                 num_encoder_layers=3, num_decoder_layers=3, vocab=30,
                 k_neighbors=64, input_size=3, learn_sigma=True, dropout=0.6,
                 adaln_mode="trunk", self_condition=False, decoder_mask=False,
                 use_seq_in_encoder=True, final_adln=True, augment_eps=0.0, remat=False):
        super().__init__()
        h = hidden_dim
        self.input_size = input_size
        self.vocab = vocab
        self.adaln_mode = adaln_mode
        self.self_condition = self_condition
        self.decoder_mask = decoder_mask
        self.use_seq_in_encoder = use_seq_in_encoder
        self.final_adln = final_adln
        self.remat = remat
        self.t_embedder = TimestepEmbedder(h, gen)
        self.features = CAProteinFeatures(edge_features, gen, top_k=k_neighbors,
                                          augment_eps=augment_eps)
        self.x_in = linear(input_size * (2 if self_condition else 1), h, gen)
        self.w_e = linear(edge_features, h, gen)
        self.w_s = embedding(vocab, h, gen, std=1.0)
        # each layer owns four dropout seed sites (nn/mpnn.py: _DropoutLayer)
        self.enc_layers = nn.ModuleList(
            EncLayerDiffusion(h, gen, dropout=dropout, site=4 * i, gate_mode=adaln_mode)
            for i in range(num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecLayerDiffusion(h, gen, dropout=dropout, site=4 * (num_encoder_layers + i),
                              gate_mode=adaln_mode, masked=decoder_mask)
            for i in range(num_decoder_layers))
        out_size = input_size * (2 if learn_sigma else 1)
        # without the adaLN head: flax's default Dense init (lecun, zero bias)
        self.w_out = (FinalLayer(h, out_size, gen) if final_adln
                      else linear(h, out_size, gen, init="lecun"))

    def compute_condition(self, res_type, cg_xyz, mask, augment_noise=None, seq=None):
        """x-independent conditioning: kNN indices, edge features, masks and
        the sequence embedding. res_type [B, L], cg_xyz [B, L, 3] (Å),
        mask [B, L]; augment_noise [B, L, 3] N(0, 1), used with augment_eps.
        With `seq` the rows are this rank's block, their positions global."""
        B, L = res_type.shape
        maskf = mask.to(cg_xyz.dtype)
        start = 0 if seq is None else seq.rank * L
        residue_idx = (start + torch.arange(L, dtype=torch.int32,
                                            device=cg_xyz.device)).expand(B, L)
        chain_labels = torch.ones((B, L), dtype=cg_xyz.dtype, device=cg_xyz.device)
        E, E_idx = self.features(cg_xyz, maskf, residue_idx, chain_labels, augment_noise,
                                 seq=seq)
        if seq is None:
            mask_table = maskf
        else:
            from codlad_tpu_torch.parallel.sequence import seq_all_gather
            mask_table = seq_all_gather(maskf, seq)
        mask_attend = maskf[..., None] * gather_nodes(mask_table[..., None], E_idx)[..., 0]
        return {"idx": E_idx.to(torch.int32), "h_E0": self.w_e(E),
                "h_S": self.w_s(res_type.long()), "maskf": maskf,
                "mask_attend": mask_attend}

    def _layer(self, layer, *args):
        if self.remat and torch.is_grad_enabled():
            return _remat(layer, *args)
        return layer(*args)

    def _head(self, h_V, c):
        return self.w_out(h_V, c) if self.final_adln else self.w_out(h_V)

    def denoise(self, x, t, cond, deterministic=True, dropout_seed=None, fuse_pairs=False,
                x_self_cond=None, decoding_randn=None, seq=None):
        """One denoiser evaluation. x [B, L, input_size] in the weights'
        dtype, t [B] or scalar base timesteps -> [B, L, out]. With
        deterministic=False the layers drop at rate `dropout`, with masks
        keyed by the integer `dropout_seed`. x_self_cond [B, L, input_size]
        (self_condition; zeros when None). decoding_randn [B, L]
        (decoder_mask): the normal draw that orders the decoding; drawn from
        a generator seeded with `dropout_seed` (or 0) when None.

        fuse_pairs=True (sampling only: K7 has no backward) runs each encoder
        layer's edge update and the next layer's node sum as one kernel
        (`_denoise_fused`). As in the JAX package, that path is taken only
        where it exists: deterministic, trunk adaLN, decoder layers present,
        no decoder mask, no remat, no `seq`; in any other mode the unfused
        path runs. With `seq` (cond from compute_condition(seq=)) the decoder
        mask raises NotImplementedError, as in JAX."""
        B, L = x.shape[:2]
        dt = x.dtype
        idx = cond["idx"]
        maskf = cond["maskf"].to(dt)
        mask_attend = cond["mask_attend"].to(dt)
        h_S = cond["h_S"].to(dt)
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B)
        c = self.t_embedder(t).to(dt)

        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond.to(dt), x], dim=-1)
        h_V = self.x_in(x)
        h_E = cond["h_E0"].to(dt)
        s_scale = 2.0 if self.use_seq_in_encoder else 1.0
        if (fuse_pairs and deterministic and self.adaln_mode == "trunk" and seq is None
                and not self.decoder_mask and not self.remat and len(self.dec_layers) > 0):
            return self._denoise_fused(h_V, h_E, idx, maskf, mask_attend, s_scale * h_S, c)
        for layer in self.enc_layers:
            h_V, h_E = self._layer(layer, h_V, h_E, idx, maskf, mask_attend, c,
                                   deterministic, dropout_seed, seq)
        h_V_enc = h_V

        if seq is not None:
            if self.decoder_mask:
                raise NotImplementedError("decoder_mask is not supported under sequence "
                                          "sharding (as in the JAX package)")
            from codlad_tpu_torch.parallel.sequence import seq_all_gather
            s_full = seq_all_gather(s_scale * h_S, seq)
            for layer in self.dec_layers:
                h_V = self._layer(layer, h_V, idx, h_E, s_full,
                                  seq_all_gather(h_V + h_V_enc, seq), maskf, c, 2.0,
                                  deterministic, dropout_seed)
            return self._head(h_V, c)

        if self.decoder_mask:
            if decoding_randn is None:
                base = dropout_seed[0] if isinstance(dropout_seed, tuple) else dropout_seed
                g = torch.Generator(device=x.device).manual_seed(int(base or 0))
                decoding_randn = torch.randn((B, L), generator=g, device=x.device)
            # argsort of (mask + 1e-4) * |randn|: ties between residues would
            # make the order depend on the sort's tie rule (the top-k trap),
            # but a continuous draw has none (the 1e-4 keeps padded residues
            # apart too); the stable sort breaks any tie lower index first,
            # as jnp.argsort does
            order = torch.argsort((maskf.float() + 1e-4) * decoding_randn.float().abs(),
                                  dim=-1, stable=True)
            pos = torch.argsort(order, dim=-1)   # each residue's place in the order
            # residue p is decoded before residue q: the JAX one-hot einsum
            backward = (pos[:, :, None] > pos[:, None, :]).to(dt)
            bw = torch.gather(backward, 2, idx.long())[..., None] * maskf[:, :, None, None]
            fw = maskf[:, :, None, None] - bw
            s_enc = h_S if self.use_seq_in_encoder else torch.zeros_like(h_S)
            edge_pre = (bw + fw) * h_E
            s_edge = bw * gather_nodes(h_S, idx) + fw * gather_nodes(s_enc, idx)
            venc_nbr = gather_nodes(h_V_enc, idx)
            for layer in self.dec_layers:
                v_edge = bw * gather_nodes(h_V, idx) + fw * venc_nbr
                h_V = self._layer(layer, h_V, idx, edge_pre, s_edge, v_edge, maskf, c, 1.0,
                                  deterministic, dropout_seed)
            return self._head(h_V, c)

        # decoder message input in split form: edge block 2*h_E (folded into
        # W_e), sequence block s_scale*h_S, node block h_V + h_V_encoder
        s_node = s_scale * h_S
        for layer in self.dec_layers:
            h_V = self._layer(layer, h_V, idx, h_E, s_node, h_V + h_V_enc, maskf, c, 2.0,
                              deterministic, dropout_seed)
        return self._head(h_V, c)

    def _denoise_fused(self, h_V, h_E, idx, maskf, mask_attend, s_node, c):
        """`denoise` with each encoder layer's edge update (K2) chained into
        the next layer's node sum (K1) by K7 (codlad_tpu/models/denoiser.py
        `_denoise_fused`). The last pair folds in the first decoder layer's
        node chain: its edge block is 2*h_E (W_e * 2), its mask all ones and
        its node block [s_node, h_V + h_V_enc] = [s_node, 2*h_V]."""
        enc = self.enc_layers
        m = [layer.mods(c) for layer in enc]
        dh = enc[0].SplitMessageChain_0(h_V, h_E, h_V, idx, mask_attend=mask_attend)
        h_V = _node_epilogue(enc[0], h_V, dh, *m[0][:6], maskf)
        h_V_enc = None
        for i, layer in enumerate(enc):
            edge = layer.SplitMessageChain_1.components(h_V, h_V)
            sh3, sc3, g3 = m[i][6:9]
            if i + 1 < len(enc):
                nxt, mods, mask = enc[i + 1], m[i + 1][:6], mask_attend
                node = nxt.SplitMessageChain_0.components(h_V, h_V)
            else:
                h_V_enc = h_V
                nxt, mask = self.dec_layers[0], torch.ones_like(mask_attend)
                mods = nxt.mods(c)
                node = nxt.chain_operands(h_V, s_node, h_V + h_V_enc, edge_scale=2.0)
            h_E, dh = fused_edge_then_sum(edge[0], h_E, edge[1], idx, *edge[2:], sh3, sc3, g3,
                                          *node, mask, nxt.SplitMessageChain_0.scale)
            h_V = _node_epilogue(nxt, h_V, dh, *mods, maskf)
        for layer in self.dec_layers[1:]:
            h_V = layer(h_V, idx, h_E, s_node, h_V + h_V_enc, maskf, c, 2.0)
        return self._head(h_V, c)

    def forward(self, x, t, res_type, cg_xyz, mask, deterministic=True,
                dropout_seed=None, x_self_cond=None, augment_noise=None,
                decoding_randn=None, seq=None):
        """The training forward (JAX `__call__`): conditioning, then one
        denoiser evaluation. x [B, L, input_size], t [B], res_type [B, L],
        cg_xyz [B, L, 3] (Å), mask [B, L] -> [B, L, out]."""
        cond = self.compute_condition(res_type, cg_xyz, mask, augment_noise, seq=seq)
        return self.denoise(x, t, cond, deterministic, dropout_seed,
                            x_self_cond=x_self_cond, decoding_randn=decoding_randn, seq=seq)

    def forward_with_cfg(self, x, t, res_type, cg_xyz, mask, cfg_scale):
        """Classifier-free guidance over a doubled batch: the first half
        conditioned, the second half on the null residue token (vocab - 1);
        the mean channels become uncond + cfg_scale * (cond - uncond) in both
        halves, the variance channels pass through."""
        half = x.shape[0] // 2
        null = torch.full_like(res_type, self.vocab - 1)
        res_type = torch.cat([res_type[:half], null[half:]], dim=0)
        out = self.denoise(x, t, self.compute_condition(res_type, cg_xyz, mask))
        C = self.input_size
        mean, rest = out[..., :C], out[..., C:]
        guided = mean[half:] + cfg_scale * (mean[:half] - mean[half:])
        return torch.cat([torch.cat([guided, guided], dim=0), rest], dim=-1)
