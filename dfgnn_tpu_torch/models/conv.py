"""Attention graph-conv layers (torch.nn).

The counterpart of :mod:`dfgnn_tpu.models.conv`.  Ported so far:
:class:`GTConv`, sparse multi-head scaled-dot attention, on its decomposed
fp32 path (q/k/v projections, then :func:`graph_attention`).

Features are node-flat ``[n_total, d]``; for a :class:`DenseBatch` the flat
order is graph-major (``b * np_pad + i``) and layers reshape internally.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import graph_attention


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal`` on a torch ``[out, in]`` weight: a normal
    truncated at two standard deviations, with variance 1 / fan_in."""
    # 0.8796... is the standard deviation of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def linear(din: int, dout: int, generator: torch.Generator, device="cuda") -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``nn.Dense``: lecun-normal
    weight, zero bias.  Drawn on the CPU from ``generator``, then moved."""
    w = lecun_normal_(torch.empty(dout, din), generator)
    lin = nn.Linear(din, dout, device="meta").to_empty(device=resolve_device(device))
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.zero_()
    return lin


def _split_heads(x: torch.Tensor, g, heads: int) -> torch.Tensor:
    """[n, heads*f] -> [n, heads, f] (flat) or [B, P, heads, f] (dense)."""
    if isinstance(g, DenseBatch):
        return x.reshape(g.n_graphs, g.np_pad, heads, -1)
    return x.reshape(x.shape[0], heads, -1)


def _merge_heads(out: torch.Tensor, g) -> torch.Tensor:
    if isinstance(g, DenseBatch):
        b, p, h, f = out.shape
        return out.reshape(b * p, h * f)
    n, h, f = out.shape
    return out.reshape(n, h * f)


class GTConv(nn.Module):
    """Sparse multi-head scaled-dot attention (graph transformer conv).

    ``q_proj``, ``k_proj`` and ``v_proj`` carry the flax layer's
    ``{kernel, bias}`` as ``Linear(weight=kernel.T, bias)``.
    """

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1,
                 method: str = "auto", *, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.out_size = out_size
        self.num_heads = num_heads
        self.method = method
        self.q_proj = linear(in_size, out_size, generator, device)
        self.k_proj = linear(in_size, out_size, generator, device)
        self.v_proj = linear(in_size, out_size, generator, device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        head_dim = self.out_size // self.num_heads
        method = impl or self.method
        if method == "auto":
            # same ablation override the dispatcher honours
            method = os.environ.get("DFGNN_TPU_FORCE_METHOD", "auto")
        if method == "flash_fused":
            raise NotImplementedError(
                "the whole-layer kernel _layer_kernel_dot (impl='flash_fused') is "
                "not ported yet: ROADMAP.md queue 2, kernel #5")
        q = self.q_proj(x) * head_dim ** -0.5
        k = self.k_proj(x)
        v = self.v_proj(x)
        out = graph_attention(
            g,
            _split_heads(q, g, self.num_heads),
            _split_heads(k, g, self.num_heads),
            _split_heads(v, g, self.num_heads),
            score="dot",
            method=method,
        )
        return _merge_heads(out, g)
