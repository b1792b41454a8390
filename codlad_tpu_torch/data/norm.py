"""Per-channel latent normalisation statistics.

Copy of the npz part of codlad_tpu/data/norm.py: Stage 2 trains on
standardised latents; the stats are `{name}_stats.npz` files with `mean` and
`std`.
"""

from __future__ import annotations

import os

import numpy as np


def save_stats(path, name, mean, std):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"{name}_stats.npz"), mean=mean, std=std)


def load_stats(path, name):
    """(mean, std) from `{path}/{name}_stats.npz`."""
    npz = os.path.join(path, f"{name}_stats.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(f"no stats named '{name}' under {path} "
                                f"(looked for {name}_stats.npz)")
    z = np.load(npz)
    return z["mean"], z["std"]


def normalize(x, mean, std, norm_in=True):
    """norm_in=True standardises; False de-standardises."""
    if norm_in:
        return (x - mean) / std
    return x * std + mean
