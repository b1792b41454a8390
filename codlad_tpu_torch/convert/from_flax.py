"""Flax parameters (nested dicts of numpy arrays) -> the port's state_dict.

The port's modules carry the flax module names, so the mapping is by name:
`enc_layers_3` becomes `enc_layers.3`; a Dense `kernel` [in, out] becomes
`weight` [out, in]; an Embed `embedding` and a LayerNorm `scale` become
`weight`; raw parameters (SplitMessageChain's W_e, W2, b2, W3, b3) keep
their name and layout. The encoder's names (`encoder/EdgeEmbed_i`,
`Embed_i`, `TPConv_i/Dense_j`, the cross graph's `Dense_i`, `map_in`) map
the same way. The VQ codebook is a plain array.

`read_flax_npz` reads the single-file export of a trained checkpoint
(scripts/export_flax_npz.py): flax-named leaves under `params/...`, the
codebook, the model config and the latent stats; nothing on the card reads
orbax.
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
    """-> {"params": nested dict of arrays, "codebook": [n_codes, dim] or
    None, "cluster_size" / "embed_avg" (the VQ state's EMA statistics) or
    None, "config": dict, "stats": (mean, std) or None} from an npz whose
    keys are `params/<module>/.../<leaf>`, `codebook`, `cluster_size`,
    `embed_avg`, `config` (JSON) and `stats_mean` / `stats_std`."""
    params = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("params/"):
                continue
            node = params
            *mods, leaf = key.split("/")[1:]
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
        get = lambda k: z[k] if k in z.files else None
        stats = ((get("stats_mean"), get("stats_std")) if "stats_mean" in z.files else None)
        return {"params": params, "codebook": get("codebook"),
                "cluster_size": get("cluster_size"), "embed_avg": get("embed_avg"),
                "config": json.loads(str(z["config"])) if "config" in z.files else {},
                "stats": stats}
