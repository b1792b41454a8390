"""Flax parameters (nested dicts of numpy arrays) -> the port's state_dict.

The port's modules carry the flax module names, so the mapping is by name:
`enc_layers_3` becomes `enc_layers.3`; a Dense `kernel` [in, out] becomes
`weight` [out, in]; an Embed `embedding` and a LayerNorm `scale` become
`weight`; raw parameters (SplitMessageChain's W_e, W2, b2, W3, b3) keep
their name and layout. The encoder's names (`encoder/EdgeEmbed_i`,
`Embed_i`, `TPConv_i/Dense_j`, the cross graph's `Dense_i`, `map_in`) map
the same way, and so do the rest of Stage 1's: CGPrior's (`EdgeEmbed_0`,
`Embed_0`, `TPConv_0..2`, `Dense_0..3`), a MuSigmaHead's `Dense_0..3` (the
mean head, then the log variance head), ICDecoderAngle's extra `_MLP2_i`,
GenZProt's `encoder`, `prior_net`, `head` and `decoder`, the VAE's `head`
(fgvae) and `prior` (cgvae). The VQ codebook is a plain array; a
quantizer's whole state is a `vq_state` tree (one VQState's fields, or a
list of them for rvq and multihead).

`read_flax_npz` reads the single-file export of a trained checkpoint
(scripts/export_flax_npz.py): flax-named leaves under `params/...` (and a
Stage-2 checkpoint's EMA under `ema_params/...`), the codebook, the model
config and the latent stats; nothing on the card reads orbax.
`denoiser_from_config` builds the Stage-2 denoiser of a run config for
evaluation, as codlad_tpu/cli/test.py does, and `load_denoiser` fills it
from such a file.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch

_LIST = re.compile(r"^(enc_layers|dec_layers)_(\d+)$")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_state_dict(params):
    """params: the flax variables ({'params': {...}}) or the inner tree."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, val in _flatten(params):
        arr = np.array(val, dtype=np.float32)
        names = [_LIST.sub(r"\1.\2", p) for p in path[:-1]]
        leaf = path[-1]
        if leaf == "kernel":
            arr = arr.T
        names.append(_LEAF.get(leaf, leaf))
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax(module, params):
    """Load flax params into `module`. Raises KeyError naming every flax leaf
    left unmapped and every torch parameter left unfilled."""
    sd = flax_to_state_dict(params)
    own = set(module.state_dict())
    unmapped, unfilled = sorted(set(sd) - own), sorted(own - set(sd))
    if unmapped or unfilled:
        raise KeyError(f"flax leaves with no torch parameter: {unmapped}; "
                       f"torch parameters with no flax leaf: {unfilled}")
    module.load_state_dict(sd, strict=True)
    return module


def codebook_from_flax(codebook, device="cuda"):
    """The VQ codebook [n_codes, dim] (e.g. `VQState.codebook`)."""
    return torch.as_tensor(np.asarray(codebook, dtype=np.float32), device=device)


def read_flax_npz(path):
    """-> {"params": nested dict of arrays, "ema_params": the same for the
    EMA weights or None, "codebook": [n_codes, dim] or None, "cluster_size"
    / "embed_avg" (the VQ state's EMA statistics) or None, "vq_state": the
    quantizer's state tree ({field: array}, or a list of them) or None,
    "config": dict, "stats": (mean, std) or None} from an npz whose keys
    are `params/<module>/.../<leaf>`, `ema_params/...`, `codebook`,
    `cluster_size`, `embed_avg`, `vq_state/<field>` or
    `vq_state/<i>/<field>`, `config` (JSON) and `stats_mean` /
    `stats_std`."""
    trees = {"params": {}, "ema_params": {}, "vq_state": {}}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            top, *mods = key.split("/")
            if top not in trees or not mods:
                continue
            node, leaf = trees[top], mods.pop()
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
        get = lambda k: z[k] if k in z.files else None
        stats = ((get("stats_mean"), get("stats_std")) if "stats_mean" in z.files else None)
        vq = trees["vq_state"]
        if vq and all(k.isdigit() for k in vq):
            vq = [vq[k] for k in sorted(vq, key=int)]
        return {"params": trees["params"], "ema_params": trees["ema_params"] or None,
                "vq_state": vq or None, "codebook": get("codebook"),
                "cluster_size": get("cluster_size"), "embed_avg": get("embed_avg"),
                "config": json.loads(str(z["config"])) if "config" in z.files else {},
                "stats": stats}


# Options of a Stage-2 run config that the port does not have yet, and the
# ROADMAP queue-1 item that brings each.
_MISSING = {"distill_tmap": 9}


def denoiser_from_config(cfg, latent_size=3):
    """The f32 MPNNDenoiser (random weights, dropout 0) of a Stage-2 run
    config (the JAX trainer's modelparams.json or the port's config.json),
    as codlad_tpu/cli/test.py:219-224 builds it for evaluation: from the
    keys `backbone`, `model` (2C output channels, learn_sigma, for diffusion
    and sbcfm; C for the other flows and backbone), `adaln_mode` and
    `self_condition`. Raises
    NotImplementedError for an option the port lacks, and ValueError for a
    `decoder_mask` config, a model JAX's evaluation does not build either
    (it reads no such key)."""
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser

    model = cfg.get("model", "diffusion")
    for key, item in _MISSING.items():
        if cfg.get(key):
            raise NotImplementedError(f"{key} is not ported (ROADMAP queue 1 item {item})")
    if cfg.get("decoder_mask"):
        raise ValueError("a decoder_mask denoiser cannot be evaluated: the JAX evaluation "
                         "builds its denoiser without the mask too")
    backbone = cfg.get("backbone", "mpnn_diffusion")
    if backbone != "mpnn_diffusion":
        raise ValueError(f"unknown denoiser backbone {backbone!r}")
    return MPNNDenoiser(torch.Generator().manual_seed(0), input_size=latent_size,
                        learn_sigma=model in ("diffusion", "sbcfm"), dropout=0.0,
                        adaln_mode=cfg.get("adaln_mode", "trunk"),
                        self_condition=bool(cfg.get("self_condition", False)))


def load_denoiser(path, device="cuda", use_ema=True, latent_size=3):
    """(MPNNDenoiser in eval mode on `device` with the EMA weights, or the
    raw ones with use_ema=False; the config; the stats (mean, std) or None)
    from a converted Stage-2 weights file."""
    w = read_flax_npz(path)
    params = w["ema_params"] if use_ema else w["params"]
    if params is None:
        raise KeyError(f"{path} holds no ema_params (pass use_ema=False for the raw weights)")
    model = load_flax(denoiser_from_config(w["config"], latent_size), params)
    return model.to(device).eval(), w["config"], w["stats"]
