"""Reference (PyTorch) checkpoints -> the port's models.

Counterpart of codlad_tpu/convert/torch_import.py. A reference state dict
(the GenZProt C2 `model.pt`, the N6 / K3 / K4 VQ-VAEs) is read with
`torch.load(weights_only=True)` and given the reference's surgery
(reference utils/model_module.py:91-108 `remove_key`: a DDP `module.`
prefix stripped, the obsolete `dist_filter` keys dropped). The converters
build the flax-named tree that the JAX converters build, key for key (a
torch Linear's weight [out, in] becomes a Dense kernel [in, out]); the
port's modules carry the flax names, so `convert/from_flax.load_flax`
fills them from it, transposing back in one place.

Every Linear and Embedding maps exactly. The equivariant tensor products
do too once the weight generators' per-path outputs are corrected by
`convert/e3nn_basis.py` (a ±1 per path from e3nn's Wigner-3j against the
port's committed coupling constants, times sqrt(2 l_out + 1) for e3nn's
'component' normalisation): node features are l <= 1, where e3nn's basis
is this one, and the l = 2 edge-harmonic basis change folds into the
corrections.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from codlad_tpu_torch.convert.e3nn_basis import correct_weight_dense
from codlad_tpu_torch.nn.irreps import Irreps

_SH_IR = Irreps("1x0e + 1x1o + 1x2e")


def _ladder(ns=12, nv=4):
    from codlad_tpu_torch.models.encoder import irrep_ladder
    return irrep_ladder(ns, nv)


def load_reference_state_dict(path):
    """model.pt -> {name: np.ndarray}, with the reference's key surgery."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if "dist_filter" in k:
            continue
        v = v.detach().cpu()
        out[k] = np.asarray((v.float() if v.dtype == torch.bfloat16 else v).numpy())
    return out


def _read(sd_or_path):
    return (load_reference_state_dict(sd_or_path)
            if isinstance(sd_or_path, (str, bytes, os.PathLike)) else sd_or_path)


def _lin(sd, name):
    """torch Linear -> flax Dense dict."""
    return {"kernel": sd[f"{name}.weight"].T.copy(), "bias": sd[f"{name}.bias"].copy()}


def _emb(sd, name):
    return {"embedding": sd[f"{name}.weight"].copy()}


def _edge_embed(sd, prefix):
    """torch Sequential(Linear, ReLU, Dropout, Linear) -> EdgeEmbed."""
    return {"Dense_0": _lin(sd, f"{prefix}.0"), "Dense_1": _lin(sd, f"{prefix}.3")}


def _tpconv(sd, prefix, in_ir, out_ir):
    """A reference TensorProductConvLayer's weight generator `fc` -> TPConv's
    Dense pair; fc.3 emits the per-path weights and takes the correction."""
    return {"Dense_0": _lin(sd, f"{prefix}.fc.0"),
            "Dense_1": correct_weight_dense(_lin(sd, f"{prefix}.fc.3"), in_ir, _SH_IR, out_ir)}


def convert_encoder(sd, prefix="encoder"):
    """Reference e3nnEncoder -> the E3Encoder subtree. Per conv layer l (flax
    creation order): TPConv (atom), Dense_{4l} (the cross graph's c2a
    weight output), Dense_{4l+1} (its hidden), and below the last layer
    TPConv (CG), Dense_{4l+2} / Dense_{4l+3} (a2c); readout Dense_10/11."""
    p = {"Embed_0": _emb(sd, f"{prefix}.atom_node_embedding"),
         "Embed_1": _emb(sd, f"{prefix}.cg_node_embedding"),
         "EdgeEmbed_0": _edge_embed(sd, f"{prefix}.atom_edge_embedding"),
         "EdgeEmbed_1": _edge_embed(sd, f"{prefix}.cg_edge_embedding"),
         "EdgeEmbed_2": _edge_embed(sd, f"{prefix}.cross_edge_embedding")}
    ladder = _ladder()
    tp_idx = 0
    for l in range(3):
        in_ir, out_ir = ladder[min(l, 3)], ladder[min(l + 1, 3)]
        p[f"TPConv_{tp_idx}"] = _tpconv(sd, f"{prefix}.atom_conv_layers.{l}", in_ir, out_ir)
        tp_idx += 1
        p[f"Dense_{4 * l}"] = correct_weight_dense(
            _lin(sd, f"{prefix}.cg_to_atom_conv_layers.{l}.fc.3"), in_ir, _SH_IR, out_ir)
        p[f"Dense_{4 * l + 1}"] = _lin(sd, f"{prefix}.cg_to_atom_conv_layers.{l}.fc.0")
        if l != 2:
            p[f"TPConv_{tp_idx}"] = _tpconv(sd, f"{prefix}.cg_conv_layers.{l}", in_ir, out_ir)
            tp_idx += 1
            p[f"Dense_{4 * l + 2}"] = correct_weight_dense(
                _lin(sd, f"{prefix}.atom_to_cg_conv_layers.{l}.fc.3"), in_ir, _SH_IR, out_ir)
            p[f"Dense_{4 * l + 3}"] = _lin(sd, f"{prefix}.atom_to_cg_conv_layers.{l}.fc.0")
    p["Dense_10"] = _lin(sd, f"{prefix}.dense.0")
    p["Dense_11"] = _lin(sd, f"{prefix}.dense.2")
    return p


def convert_prior(sd, prefix="prior_net"):
    """Reference CG prior -> the CGPrior subtree."""
    p = {"Embed_0": _emb(sd, f"{prefix}.cg_node_embedding"),
         "EdgeEmbed_0": _edge_embed(sd, f"{prefix}.cg_edge_embedding")}
    ladder = _ladder()
    for l in range(3):
        p[f"TPConv_{l}"] = _tpconv(sd, f"{prefix}.cg_conv_layers.{l}", ladder[min(l, 3)],
                                   ladder[min(l + 1, 3)])
    p["Dense_0"] = _lin(sd, f"{prefix}.mu.0")
    p["Dense_1"] = _lin(sd, f"{prefix}.mu.2")
    p["Dense_2"] = _lin(sd, f"{prefix}.sigma.0")
    p["Dense_3"] = _lin(sd, f"{prefix}.sigma.2")
    return p


def _invariant_blocks(sd, prefix, nc):
    p = {}
    for i in range(nc):
        p[f"InvariantMessage_{i}"] = {
            "Dense_0": _lin(sd, f"{prefix}.message_blocks.{i}.inv_dense.0"),
            "Dense_1": _lin(sd, f"{prefix}.message_blocks.{i}.inv_dense.1"),
            "DistanceEmbed_0": {
                "Dense_0": _lin(sd, f"{prefix}.message_blocks.{i}.dist_embed.block.1")}}
        p[f"_MLP2_{i}"] = _mlp2(sd, f"{prefix}.dense_blocks.{i}")
    return p


def _mlp2(sd, prefix):
    """torch Sequential(act, Linear, act, Linear) -> _MLP2."""
    return {"Dense_0": _lin(sd, f"{prefix}.1"), "Dense_1": _lin(sd, f"{prefix}.3")}


def convert_ic_decoder(sd, prefix="equivaraintconv", num_conv=4):
    """Reference IC_Decoder -> the ICDecoder subtree. Embed_0..3: backbone_dist,
    sidechain_dist, res_embed, sidechain_angle; _MLP2_{0..nc-1} the dense
    blocks, _MLP2_{nc} backbone_angle, _MLP2_{nc+1} backbone_torsion,
    _MLP2_{nc+2..2nc+1} the side-chain torsion blocks, _MLP2_{2nc+2} the
    final torsion."""
    nc = num_conv
    p = {"Embed_0": _emb(sd, f"{prefix}.backbone_dist"),
         "Embed_1": _emb(sd, f"{prefix}.sidechain_dist"),
         "Embed_2": _emb(sd, f"{prefix}.res_embed"),
         "Embed_3": _emb(sd, f"{prefix}.sidechain_angle"),
         **_invariant_blocks(sd, prefix, nc),
         f"_MLP2_{nc}": _mlp2(sd, f"{prefix}.backbone_angle"),
         f"_MLP2_{nc + 1}": _mlp2(sd, f"{prefix}.backbone_torsion")}
    for i in range(nc):
        p[f"_MLP2_{nc + 2 + i}"] = _mlp2(sd, f"{prefix}.sidechain_torsion_blocks.{i}")
    p[f"_MLP2_{2 * nc + 2}"] = _mlp2(sd, f"{prefix}.final_torsion")
    return p


def convert_ic_decoder_angle(sd, prefix="equivaraintconv", num_conv=4):
    """Reference IC_Decoder_angle (the K3 / K4 layout, reference
    vae_model.py:318-415) -> the ICDecoderAngle subtree: sidechain_angle is
    an MLP, _MLP2_{nc+2}, with no Embed_3, so the side-chain torsion chain
    moves up one slot."""
    nc = num_conv
    p = {"Embed_0": _emb(sd, f"{prefix}.backbone_dist"),
         "Embed_1": _emb(sd, f"{prefix}.sidechain_dist"),
         "Embed_2": _emb(sd, f"{prefix}.res_embed"),
         **_invariant_blocks(sd, prefix, nc),
         f"_MLP2_{nc}": _mlp2(sd, f"{prefix}.backbone_angle"),
         f"_MLP2_{nc + 1}": _mlp2(sd, f"{prefix}.backbone_torsion"),
         f"_MLP2_{nc + 2}": _mlp2(sd, f"{prefix}.sidechain_angle")}
    for i in range(nc):
        p[f"_MLP2_{nc + 3 + i}"] = _mlp2(sd, f"{prefix}.sidechain_torsion_blocks.{i}")
    p[f"_MLP2_{2 * nc + 3}"] = _mlp2(sd, f"{prefix}.final_torsion")
    return p


def is_angle_layout(sd, prefix="equivaraintconv"):
    """True for the IC_Decoder_angle (K3 / K4) layout: sidechain_angle an MLP,
    not an Embedding (reference model_module.py:56,70)."""
    return f"{prefix}.sidechain_angle.1.weight" in sd


def convert_vae(sd_or_path, num_conv=4, embed_dim=36, vqdim=3, predict_angle=None):
    """A reference VQ-VAE (N6 / K3 / K4) -> ({"params": flax-named tree}, VQ
    arrays {codebook, cluster_size, embed_avg} or None).

    predict_angle None detects the decoder layout (`is_angle_layout`);
    True / False force it. vector_quantize_pytorch's buffers
    `quantize._codebook.embed / embed_avg / cluster_size` are read with
    their leading codebook-group axis squeezed."""
    sd = _read(sd_or_path)
    if predict_angle is None:
        predict_angle = is_angle_layout(sd)
    dec = convert_ic_decoder_angle if predict_angle else convert_ic_decoder
    params = {"encoder": convert_encoder(sd), "decoder": dec(sd, num_conv=num_conv)}
    if embed_dim != vqdim and "map_in.weight" in sd:
        params["map_in"] = _lin(sd, "map_in")
        params["map_out"] = _lin(sd, "map_out")

    vq = None
    embed_key = next((k for k in sd if k.endswith("_codebook.embed")), None)
    if embed_key is not None:
        base = embed_key[: -len(".embed")]
        squeeze = lambda a: a[0] if a.ndim == 3 else a
        get = lambda name, fallback: sd.get(f"{base}.{name}", fallback)
        codebook = squeeze(sd[embed_key])
        vq = {"codebook": codebook,
              "embed_avg": squeeze(get("embed_avg", codebook.copy())),
              "cluster_size": get("cluster_size",
                                  np.ones(codebook.shape[0], np.float32)).reshape(-1)}
    return {"params": params}, vq


def convert_genzprot(sd_or_path, num_conv=4):
    """A reference GenZProt (C2) -> {"params": flax-named tree}."""
    sd = _read(sd_or_path)
    head = {"Dense_0": _lin(sd, "atom_munet.0"), "Dense_1": _lin(sd, "atom_munet.2"),
            "Dense_2": _lin(sd, "atom_sigmanet.0"), "Dense_3": _lin(sd, "atom_sigmanet.2")}
    return {"params": {"encoder": convert_encoder(sd), "prior_net": convert_prior(sd),
                       "head": head, "decoder": convert_ic_decoder(sd, num_conv=num_conv)}}
