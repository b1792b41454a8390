"""Shared conditioning layers and parameter init.

Counterpart of codlad_tpu/nn/layers.py: `timestep_embedding`,
`TimestepEmbedder`, `FinalLayer`, and the init schemes the JAX package
uses. Modules are created without touching torch's global RNG
(`skip_init`) and initialised from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init


def _uniform(t, bound, gen):
    nn.init.uniform_(t, -bound, bound, generator=gen)


def linear(in_f, out_f, gen, bias=True, init="torch"):
    """nn.Linear initialised like its flax counterpart.

    init='torch': xavier-uniform weight and torch's default bias
      U(-1/sqrt(in), 1/sqrt(in)) (`torch_linear_init`). The nonzero biases
      matter: with zero biases the adaLN-gated trunk has zero gradient at
      every gate.
    init='xavier': xavier-uniform weight, zero bias.
    init='lecun': flax's Dense default (truncated-normal lecun), zero bias.
    init='zeros': all zeros (adaLN modulation heads).
    """
    lin = skip_init(nn.Linear, in_f, out_f, bias=bias)
    with torch.no_grad():
        w = lin.weight
        if init == "zeros":
            w.zero_()
        elif init in ("torch", "xavier"):
            nn.init.xavier_uniform_(w, generator=gen)
        elif init == "lecun":
            std = math.sqrt(1.0 / in_f) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
        else:
            raise ValueError(init)
        if bias:
            if init == "torch":
                _uniform(lin.bias, 1.0 / math.sqrt(in_f), gen)
            else:
                lin.bias.zero_()
    return lin


def embedding(num, dim, gen, std=None):
    """nn.Embedding with N(0, std^2) rows (default std 1/sqrt(dim))."""
    emb = skip_init(nn.Embedding, num, dim)
    with torch.no_grad():
        emb.weight.normal_(0.0, std if std is not None else 1.0 / math.sqrt(dim),
                           generator=gen)
    return emb


def raw_param(shape, gen, init="xavier", fan_in=None):
    """A bare parameter: xavier-uniform [in, out] or U(+-1/sqrt(fan_in))."""
    p = torch.empty(shape)
    if init == "xavier":
        nn.init.xavier_uniform_(p, generator=gen)
    else:
        _uniform(p, 1.0 / math.sqrt(fan_in), gen)
    return nn.Parameter(p)


def layer_norm(x, eps=1e-6):
    """LayerNorm without scale or bias (flax use_bias=False, use_scale=False)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal embeddings; t [B] (int or fractional) -> f32 [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size, gen, frequency_embedding_size=256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.Dense_0 = linear(frequency_embedding_size, hidden_size, gen)
        self.Dense_1 = linear(hidden_size, hidden_size, gen)

    def forward(self, t):
        """-> f32 [B, hidden]. Runs in f32 whatever the weights' dtype, as
        flax promotes the f32 embedding against bf16 weights."""
        h = timestep_embedding(t, self.frequency_embedding_size)
        f32 = torch.float32
        h = F.silu(F.linear(h, self.Dense_0.weight.to(f32), self.Dense_0.bias.to(f32)))
        return F.linear(h, self.Dense_1.weight.to(f32), self.Dense_1.bias.to(f32))


class FinalLayer(nn.Module):
    """adaLN-modulated LayerNorm -> Linear projection."""

    def __init__(self, hidden_size, out_size, gen):
        super().__init__()
        self.Dense_0 = linear(hidden_size, 2 * hidden_size, gen, init="zeros")
        self.Dense_1 = linear(hidden_size, out_size, gen)

    def forward(self, x, c):
        shift, scale = self.Dense_0(F.silu(c)).chunk(2, dim=-1)
        x = layer_norm(x)
        x = x * (1 + scale[:, None, :]) + shift[:, None, :]
        return self.Dense_1(x)
