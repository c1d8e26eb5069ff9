"""Attention graph-conv layers (torch.nn).

The counterpart of :mod:`dfgnn_tpu.models.conv`: the four conv families on
their decomposed fp32 paths (projections, then :func:`graph_attention`).

* :class:`GTConv`     sparse multi-head scaled-dot attention
* :class:`GATConv`    additive attention (kernels #2 and #4 on a DenseBatch)
* :class:`AGNNConv`   cosine attention: the dot path on l2-normalised features
* :class:`DotGATConv` dot-product GAT, Q = K = V = fc(h)

The whole-layer kernels (``impl="flash_fused"``) are not ported yet.  Each
module's parameters carry the flax layer's names, so
:mod:`dfgnn_tpu_torch.weights` maps a flax tree onto them.

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


def linear(din: int, dout: int, generator: torch.Generator, device="cuda",
           init=lecun_normal_) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``nn.Dense``: ``init(weight,
    generator)`` (lecun-normal by default), zero bias.  Drawn on the CPU from
    ``generator``, then moved."""
    w = init(torch.empty(dout, din), generator)
    lin = nn.Linear(din, dout, device="meta").to_empty(device=resolve_device(device))
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.zero_()
    return lin


def xavier_relu_(w: torch.Tensor, fan_in: int, fan_out: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Flax's ``variance_scaling(2.0, "fan_avg", "normal")``, the GAT init: a
    plain (untruncated) normal with variance 2 / ((fan_in + fan_out) / 2)."""
    return w.normal_(std=math.sqrt(4.0 / (fan_in + fan_out)), generator=generator)


def _parameter(w: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(w.to(resolve_device(device)))


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


class GATConv(nn.Module):
    """Additive-attention conv: score = LeakyReLU(a_l . Wh_row + a_r . Wh_col).

    The head dim is ``out_size``: ``W`` is ``Linear(in_size, out_size *
    num_heads)``, and ``a_l``, ``a_r`` are ``[out_size, num_heads]`` as in
    flax, all drawn with the xavier-relu init (zero bias).  ``dropout``
    drops attention weights in training (``deterministic=False``), drawn
    from ``dropout_generator``: a CPU generator for the flash kernels (the
    edge hash's seed), any generator for the dense path and the oracle.
    """

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1,
                 negative_slope: float = 0.2, dropout: float = 0.0, method: str = "auto", *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.out_size = out_size
        self.num_heads = num_heads
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.method = method
        width = out_size * num_heads
        self.W = linear(in_size, width, generator, device,
                        init=lambda w, gen: xavier_relu_(w, in_size, width, gen))
        self.a_l = _parameter(xavier_relu_(torch.empty(out_size, num_heads), out_size,
                                           num_heads, generator), device)
        self.a_r = _parameter(xavier_relu_(torch.empty(out_size, num_heads), out_size,
                                           num_heads, generator), device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None,
                deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        method = impl or self.method
        if method == "auto":
            method = os.environ.get("DFGNN_TPU_FORCE_METHOD", "auto")
        if method == "flash_fused":
            raise NotImplementedError(
                "the whole-layer kernel _layer_kernel_add (impl='flash_fused') is "
                "not ported yet: ROADMAP.md queue 2, kernel #6")
        z = self.W(x)
        zh = z.reshape(z.shape[0], self.num_heads, self.out_size)
        # e_l / e_r: per-node per-head scalars
        e_l = torch.einsum("nhf,fh->nh", zh, self.a_l)
        e_r = torch.einsum("nhf,fh->nh", zh, self.a_r)
        if isinstance(g, DenseBatch):
            e_l = e_l.reshape(g.n_graphs, g.np_pad, self.num_heads)
            e_r = e_r.reshape(g.n_graphs, g.np_pad, self.num_heads)
        out = graph_attention(
            g, None, None, _split_heads(z, g, self.num_heads),
            score="add", e_row=e_l, e_col=e_r, negative_slope=self.negative_slope,
            dropout_rate=0.0 if deterministic else self.dropout,
            dropout_generator=dropout_generator, method=method,
        )
        return _merge_heads(out, g)


class AGNNConv(nn.Module):
    """Cosine-similarity attention: Q = K = l2norm(h), V = h, on the dot path,
    after the projection ``proj`` (when ``project``)."""

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1, project: bool = True,
                 method: str = "auto", *, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.method = method
        self.proj = linear(in_size, out_size, generator, device) if project else None

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        h = self.proj(x) if self.proj is not None else x
        hn = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-12)
        method = impl or self.method
        if method == "auto":
            method = os.environ.get("DFGNN_TPU_FORCE_METHOD", "auto")
        qk = _split_heads(hn, g, self.num_heads)
        out = graph_attention(g, qk, qk, _split_heads(h, g, self.num_heads), score="dot",
                              method=method)
        return _merge_heads(out, g)


class DotGATConv(nn.Module):
    """Dot-product GAT: Q = K = V = fc(h)."""

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1, method: str = "auto",
                 *, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.method = method
        self.fc = linear(in_size, out_size, generator, device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        zh = _split_heads(self.fc(x), g, self.num_heads)
        out = graph_attention(g, zh, zh, zh, score="dot", method=impl or self.method)
        return _merge_heads(out, g)


CONVS = {"gt": GTConv, "gat": GATConv, "agnn": AGNNConv, "dotgat": DotGATConv}


def make_conv(conv: str, in_size: int, out_size: int, num_heads: int = 1, **kw) -> nn.Module:
    """String-keyed conv factory, as the JAX package's ``make_conv``; torch
    modules also take their input width ``in_size``."""
    try:
        cls = CONVS[conv]
    except KeyError:
        raise KeyError(f"unknown conv {conv!r}; choose from {sorted(CONVS)}") from None
    return cls(in_size, out_size, num_heads, **kw)
