"""Attention graph-conv layers (torch.nn).

The counterpart of :mod:`dfgnn_tpu.models.conv`: the four conv families,
each a parameterisation of :func:`graph_attention`.

* :class:`GTConv`     sparse multi-head scaled-dot attention
* :class:`GATConv`    additive attention (kernels #2 and #4 on a DenseBatch)
* :class:`AGNNConv`   cosine attention: the dot path on l2-normalised features
* :class:`DotGATConv` dot-product GAT, Q = K = V = fc(h)

On a :class:`DenseBatch`, ``impl="flash_fused"`` runs the whole GT or GAT
layer as one kernel (#5 or #6, :func:`flash_layer_attention` and
:func:`flash_layer_attention_gat`) with the same parameters as the
decomposed path.  ``dtype=torch.bfloat16`` on GT, GAT and AGNN behaves as
flax's ``nn.Dense(dtype=bf16)``: the input and the fp32 parameters are cast
for each forward, and the parameters stay fp32.  Each module's parameters
carry the flax layer's names, so :mod:`dfgnn_tpu_torch.weights` maps a flax
tree onto them.

Features are node-flat ``[n_total, d]``; for a :class:`DenseBatch` the flat
order is graph-major (``b * np_pad + i``) and layers reshape internally.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import graph_attention
from dfgnn_tpu_torch.ops.flash_mask import (flash_layer_attention, flash_layer_attention_gat,
                                            flash_takes, layer_fits)


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


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax's ``nn.Dense(dtype=dtype)``: with a dtype, ``x`` and the fp32
    weight and bias are cast to it and the product is in it."""
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _resolve(method: str) -> str:
    """``auto`` becomes ``DFGNN_TPU_FORCE_METHOD`` when set, the ablation
    override the dispatcher honours; it is read before the bf16 routing."""
    if method == "auto":
        return os.environ.get("DFGNN_TPU_FORCE_METHOD", "auto")
    return method


# The bf16 auto routing's thresholds, from four runs of the shmoo twin's grid
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, the shmoo table): tokens are
# n_graphs * np_pad (grid points 8192 to 262144), widths the conv's out_size
# (16 to 256).  Each sits between the grid points where the winner changes,
# on the side of the winner of most runs.
GT_DENSE_TOKENS = 49_152    # flash won bs=256 in 4 runs; bs=512 split 2:2; dense bs >= 1024
GT_DENSE_WIDTH = 192        # dense won dim 256 in 3 runs of 4, flash dim 128 in all
GT_FUSED_TOKENS = 24_576    # flash_fused won bs=128 (16384 tokens) in 4 runs, flash bs=256
GT_FUSED_WIDTH = 96         # flash_fused won dims 16 to 64 at bs=256 in 3 runs of 4 each
AGNN_DENSE_TOKENS = 98_304  # flash won bs=512 in 3 runs of 4, dense bs >= 1024 in all
AGNN_DENSE_WIDTH = 192      # dense won dim 256 in 3 runs of 4, flash dims <= 128 in all
# bf16 GAT: the whole-layer kernel #6 up to P = 128 (one block projects each
# graph's z once), and past it only up to this many padded nodes, since its
# stream block projects each live key tile's z once per 128 query rows.
# chip_smoke.py's phase 10b times a bf16 GATConv forward (din = f = 128)
# through #6 and through the flash route (F.linear, the score contractions
# and kernel #2) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6):
# P = 256 (128 graphs) 0.1756 and 0.1766 against 0.2429 and 0.2913 ms, P =
# 512 (64 graphs) 0.3085 and 0.3131 against 0.2844 and 0.2304, in two runs.
# Two later runs read 0.1812, 0.1819 against 0.2445, 0.2573 at P = 256 and
# 0.3269, 0.3134 against 0.4844, 0.3090 at P = 512: the flash route is
# host-bound and spreads, but wins at 512 on the median of the four runs.
# The bound sits between the two points, as the thresholds above do.
GAT_FUSED_MAX_P = 384
# bf16 GAT: #6 only up to this head dim, where its whole block (P <= 128)
# projects each node's z once; past it #6 runs a stream block that projects
# the nodes of each graph three times (f <= 256), or forms e_l and e_r in a
# first launch and projects z again as v (f > 256), on mma.sync where the
# flash route projects once on cuBLAS.  chip_smoke.py's phase 27 times a
# bf16 GATConv forward (din 512, P = 128, 1024 graphs) through #6 and
# through the flash route on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# section 6), in three runs: head dim 512 2.3617, 2.3697, 2.3837 against
# 1.3760, 1.3594, 1.3633 ms; 384 1.8409, 1.8478, 1.8468 against 1.1676,
# 1.1692, 1.1678; 256 3.4741, 3.3904, 3.3942 against 0.8074, 0.7924,
# 0.7942; 192 2.7105, 2.6425 against 0.7060, 0.7003; 128 0.5204, 0.5332
# against 0.4663, 0.4977.  At 128 the projection's share decides (din 512
# here); phase 16's shmoo reads dim 128 (din 128, bs=1024) 0.2626 against
# 0.4132, so the bound sits at 128, below every point #6 lost by 1.5x or
# more.
GAT_FUSED_MAX_F = 128


def _auto_bf16_dense_batch(conv: str, g: DenseBatch, out_size: int,
                           head_dim: Optional[int] = None) -> str:
    """The measured winner for bf16 ``method="auto"`` on a DenseBatch.

    The JAX rule's three outcomes on its two observables (token count and
    width, edge values barring ``flash_fused``), with the H100's thresholds
    and directions: on the card the whole-layer kernel wins where the work
    is small (one launch where the other impls run several; the thresholds
    date from its CUDA-core projections, which lost once the work grew, and
    their retune is queued in ROADMAP.md section 2) and the dense formulation, on
    cuBLAS's bf16 tensor cores, wins at large token counts, the reverse of
    the v5e's crossovers.  GT: ``dense`` at or above ``GT_DENSE_TOKENS``
    tokens or ``GT_DENSE_WIDTH``; else ``flash_fused`` below
    ``GT_FUSED_TOKENS`` tokens or ``GT_FUSED_WIDTH`` when the batch has no
    edge values; else ``flash``.  AGNN (no whole-layer kernel: the l2 norm
    sits between projection and attention): ``dense`` at or above
    ``AGNN_DENSE_TOKENS`` tokens or ``AGNN_DENSE_WIDTH``, else ``flash``.
    GAT's bf16 auto is ``flash_fused`` (:func:`_auto_bf16_gat`), which won
    every grid point but one (dim 16, in one run of four).  The grid's
    table is in PERF.md (section 6), from ``scripts/shmoo.py``.

    Both are shape rules on what the kernels take as well: ``flash_fused``
    only where kernel #5 takes the shape (:func:`layer_fits` at the head
    dim, ``out_size`` by default), else ``flash``; ``flash`` only where
    kernels #1 and #3 take the shape (:func:`flash_takes`), else ``dense``.
    Both take every shape (any head dim, any P), so only the thresholds
    decide.
    """
    f = out_size if head_dim is None else head_dim
    n_tokens = g.n_graphs * g.np_pad
    if conv == "gt":
        if n_tokens >= GT_DENSE_TOKENS or out_size >= GT_DENSE_WIDTH:
            return "dense"
        if (g.val is None and (n_tokens < GT_FUSED_TOKENS or out_size < GT_FUSED_WIDTH)
                and layer_fits("dot", g.np_pad, f)):
            return "flash_fused"
        return "flash" if flash_takes("dot", g.np_pad, f) else "dense"
    if n_tokens >= AGNN_DENSE_TOKENS or out_size >= AGNN_DENSE_WIDTH:
        return "dense"
    return "flash" if flash_takes("dot", g.np_pad, f) else "dense"


def _auto_bf16_gat(g: DenseBatch, head_dim: int) -> str:
    """GAT's bf16 ``method="auto"`` on a DenseBatch.  With edge values it
    stays ``auto`` (the decomposed layer, where the dispatcher takes flash).
    Without, the whole-layer kernel #6 where it takes the shape
    (:func:`layer_fits`: every shape) and ``np_pad`` and ``head_dim`` are at
    most ``GAT_FUSED_MAX_P`` and ``GAT_FUSED_MAX_F``, the measured bounds
    (JAX's bf16 GAT always fuses); else ``flash`` where kernels #2 and #4
    take the shape (:func:`flash_takes`: every shape), else ``dense``."""
    if g.val is not None:
        return "auto"
    if (layer_fits("add", g.np_pad, head_dim) and g.np_pad <= GAT_FUSED_MAX_P
            and head_dim <= GAT_FUSED_MAX_F):
        return "flash_fused"
    return "flash" if flash_takes("add", g.np_pad, head_dim) else "dense"


class GTConv(nn.Module):
    """Sparse multi-head scaled-dot attention (graph transformer conv).

    ``q_proj``, ``k_proj`` and ``v_proj`` carry the flax layer's
    ``{kernel, bias}`` as ``Linear(weight=kernel.T, bias)``.  On a
    :class:`DenseBatch`, ``impl="flash_fused"`` runs the whole layer as
    kernel #5 with those parameters.  ``dtype=torch.bfloat16`` runs the
    projections and the attention in bf16 (fp32 softmax and sums inside the
    kernels), and its ``method="auto"`` on a DenseBatch follows
    :func:`_auto_bf16_dense_batch`.
    """

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1,
                 method: str = "auto", dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.out_size = out_size
        self.num_heads = num_heads
        self.method = method
        self.dtype = dtype
        self.q_proj = linear(in_size, out_size, generator, device)
        self.k_proj = linear(in_size, out_size, generator, device)
        self.v_proj = linear(in_size, out_size, generator, device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        head_dim = self.out_size // self.num_heads
        if self.dtype is not None:
            x = x.to(self.dtype)
        method = _resolve(impl or self.method)
        if method == "auto" and self.dtype == torch.bfloat16 and isinstance(g, DenseBatch):
            method = _auto_bf16_dense_batch("gt", g, self.out_size, head_dim)
        if method == "flash_fused":
            return flash_layer_attention(
                g, x, self.q_proj.weight.T, self.q_proj.bias, self.k_proj.weight.T,
                self.k_proj.bias, self.v_proj.weight.T, self.v_proj.bias,
                num_heads=self.num_heads, scale=head_dim ** -0.5)
        q = _dense(self.q_proj, x, self.dtype) * head_dim ** -0.5
        k = _dense(self.k_proj, x, self.dtype)
        v = _dense(self.v_proj, x, self.dtype)
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
    On a :class:`DenseBatch` without edge values, ``impl="flash_fused"`` runs
    the whole layer as kernel #6, and so does ``method="auto"`` with
    ``dtype=torch.bfloat16`` where :func:`_auto_bf16_gat` routes to it.  In bf16, z is bf16 and e_l, e_r are fp32 (JAX
    promotes the bf16 z against the fp32 a_l, a_r).
    """

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1,
                 negative_slope: float = 0.2, dropout: float = 0.0, method: str = "auto",
                 dtype: Optional[torch.dtype] = None, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.out_size = out_size
        self.num_heads = num_heads
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.method = method
        self.dtype = dtype
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
        if self.dtype is not None:
            x = x.to(self.dtype)
        method = _resolve(impl or self.method)
        rate = 0.0 if deterministic else self.dropout
        if method == "auto" and self.dtype == torch.bfloat16 and isinstance(g, DenseBatch):
            method = _auto_bf16_gat(g, self.out_size)
        if method == "flash_fused":
            return flash_layer_attention_gat(
                g, x, self.W.weight.T, self.W.bias, self.a_l, self.a_r,
                num_heads=self.num_heads, negative_slope=self.negative_slope,
                dropout_rate=rate, dropout_generator=dropout_generator)
        z = _dense(self.W, x, self.dtype)
        zh = z.reshape(z.shape[0], self.num_heads, self.out_size)
        # e_l / e_r: per-node per-head scalars, in the promoted dtype of z and
        # a_l (fp32 for a bf16 z), as jnp.einsum gives them
        dt = torch.promote_types(z.dtype, self.a_l.dtype)
        e_l = torch.einsum("nhf,fh->nh", zh.to(dt), self.a_l.to(dt))
        e_r = torch.einsum("nhf,fh->nh", zh.to(dt), self.a_r.to(dt))
        if isinstance(g, DenseBatch):
            e_l = e_l.reshape(g.n_graphs, g.np_pad, self.num_heads)
            e_r = e_r.reshape(g.n_graphs, g.np_pad, self.num_heads)
        out = graph_attention(
            g, None, None, _split_heads(z, g, self.num_heads),
            score="add", e_row=e_l, e_col=e_r, negative_slope=self.negative_slope,
            dropout_rate=rate, dropout_generator=dropout_generator, method=method,
        )
        return _merge_heads(out, g)


class AGNNConv(nn.Module):
    """Cosine-similarity attention: Q = K = l2norm(h), V = h, on the dot path,
    after the projection ``proj`` (when ``project``).  ``dtype`` as
    :class:`GTConv`'s; bf16 ``method="auto"`` on a DenseBatch follows
    :func:`_auto_bf16_dense_batch`."""

    def __init__(self, in_size: int, out_size: int, num_heads: int = 1, project: bool = True,
                 method: str = "auto", dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.out_size = out_size
        self.num_heads = num_heads
        self.method = method
        self.dtype = dtype
        self.proj = linear(in_size, out_size, generator, device) if project else None

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = _dense(self.proj, x, self.dtype) if self.proj is not None else x
        hn = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-12)
        method = _resolve(impl or self.method)
        if method == "auto" and self.dtype == torch.bfloat16 and isinstance(g, DenseBatch):
            method = _auto_bf16_dense_batch("agnn", g, self.out_size,
                                            self.out_size // self.num_heads)
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
