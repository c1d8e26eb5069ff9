"""Model assembly: input projections, pooling, full models.

The counterpart of :mod:`dfgnn_tpu.models.model`: ``Model`` (inproj and one
conv), the graph-level ``GTModel``, the node-level ``FullGraphNet`` and the
multi-layer ``GATNet``.  ``FullGraphNet`` takes the JAX package's ``dtype``:
bf16 for its conv stack, with the projections and log-softmax in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.formats import BlockedBucketedGraph, BucketedGraph
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.models.conv import GATConv, GTConv, linear, make_conv

# ogb full_atom_feature_dims: vocab sizes of the 9 categorical atom features
_ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)

_ATOM_DATASETS = ("ogbg-molhiv", "ogbg-molpcba", "Peptides-func", "Peptides-struct")
_EMBED_VOCAB = {"PATTERN": 3, "CLUSTER": 7}
_DENSE_DATASETS = ("MNIST", "CIFAR10", "PascalVOC-SP", "COCO-SP", "digits", "digits-func")


def embedding(vocab: int, dim: int, generator: torch.Generator, device="cuda") -> nn.Embedding:
    """``nn.Embedding`` initialised as flax's ``nn.Embed``: a normal with
    variance 1 / dim.  Drawn on the CPU from ``generator``, then moved."""
    w = torch.empty(vocab, dim).normal_(std=dim ** -0.5, generator=generator)
    emb = nn.Embedding(vocab, dim, device="meta").to_empty(device=resolve_device(device))
    with torch.no_grad():
        emb.weight.copy_(w)
    return emb


class AtomEncoder(nn.Module):
    """Sum of per-feature embeddings over the ogb atom-feature columns."""

    def __init__(self, hidden_size: int, *, generator: torch.Generator, device="cuda"):
        super().__init__()
        for i, vocab in enumerate(_ATOM_FEATURE_DIMS):
            setattr(self, f"atom_{i}", embedding(vocab, hidden_size, generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: [n, 9] int
        out = 0
        for i, vocab in enumerate(_ATOM_FEATURE_DIMS):
            # clip out-of-range ids, as the JAX package does
            out = out + getattr(self, f"atom_{i}")(x[..., i].clamp(0, vocab - 1))
        return out


def choose_inproj(dataset_name: str, hidden_size: int, *, in_size: Optional[int] = None,
                  generator: torch.Generator, device="cuda") -> nn.Module:
    """Dataset-specific input projection.  The Dense datasets need
    ``in_size``, the width of their node features."""
    if dataset_name in _ATOM_DATASETS:
        return AtomEncoder(hidden_size, generator=generator, device=device)
    if dataset_name in _EMBED_VOCAB:
        return embedding(_EMBED_VOCAB[dataset_name], hidden_size, generator, device)
    if dataset_name in _DENSE_DATASETS:
        if in_size is None:
            raise ValueError(f"dataset {dataset_name} needs in_size for its Dense inproj")
        return linear(in_size, hidden_size, generator, device)
    raise ValueError(f"unknown dataset {dataset_name}")


def graph_pool(g, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Per-graph pooling of node-flat features into ``[n_graphs, d]``.
    Padded nodes contribute zero."""
    if op not in ("sum", "mean"):
        raise ValueError(op)
    if isinstance(g, DenseBatch):
        s = torch.where(g.node_mask[..., None], x.reshape(g.n_graphs, g.np_pad, -1), 0.0).sum(1)
        cnt = g.node_mask.sum(dim=1, keepdim=True)
    elif isinstance(g, (Graph, BucketedGraph, BlockedBucketedGraph)):
        if g.graph_id is None:
            s = x.sum(dim=0, keepdim=True)
            return s if op == "sum" else s / x.shape[0]
        node_mask = getattr(g, "node_mask", None)
        real = (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
                if node_mask is None else node_mask)
        xm = torch.where(real[:, None], x, 0.0)
        s = xm.new_zeros((g.n_graphs, x.shape[1])).index_add(0, g.graph_id, xm)
        cnt = xm.new_zeros((g.n_graphs, 1)).index_add(0, g.graph_id, real[:, None].to(x.dtype))
    else:
        raise TypeError(f"graph_pool takes no layout {type(g).__name__}")
    return s if op == "sum" else s / cnt.clamp_min(1)


class Model(nn.Module):
    """inproj -> a single conv (the reference's ``Model``), node-level output.

    Weights of a JAX model come in through
    :func:`dfgnn_tpu_torch.weights.model_params_from_flax`.
    """

    def __init__(self, dataset_name: str, conv: str, hidden_size: int, num_heads: int = 1,
                 method: str = "auto", *, in_size: Optional[int] = None,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.inproj = choose_inproj(dataset_name, hidden_size, in_size=in_size,
                                    generator=generator, device=device)
        self.conv = make_conv(conv, hidden_size, hidden_size, num_heads, method=method,
                              generator=generator, device=device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        return self.conv(g, self.inproj(x), impl=impl)


class GTModel(nn.Module):
    """Graph-level model: inproj -> num_layers x GTConv -> sum-pool -> head.

    Parameters are drawn from ``generator`` in module order; weights of a
    JAX model come in through :func:`dfgnn_tpu_torch.weights.gtmodel_params_from_flax`.
    """

    def __init__(self, dataset_name: str, out_size: int, hidden_size: int = 64,
                 num_layers: int = 8, num_heads: int = 1, method: str = "auto", *,
                 in_size: Optional[int] = None, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.inproj = choose_inproj(dataset_name, hidden_size, in_size=in_size,
                                    generator=generator, device=device)
        self.layers = nn.ModuleList(
            GTConv(hidden_size, hidden_size, num_heads, method,
                   generator=generator, device=device)
            for _ in range(num_layers))
        self.predictor = linear(hidden_size, out_size, generator, device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        h = self.inproj(x)
        for layer in self.layers:
            h = layer(g, h, impl=impl)
        return self.predictor(graph_pool(g, h, "sum"))


class FullGraphNet(nn.Module):
    """Node-level model: input_proj -> num_layers x conv -> output_proj ->
    log_softmax (the reference's full-graph ``Net``).

    ``remat=True`` recomputes each conv layer in the backward
    (``torch.utils.checkpoint``), the JAX package's ``nn.remat``.
    ``dtype=torch.bfloat16`` runs the conv stack in bf16 (each conv's
    ``dtype``; GAT's bf16 auto is then kernel #6 on a DenseBatch); the
    parameters stay fp32, and the stack's output is cast to fp32 before
    ``output_proj``.
    """

    def __init__(self, conv: str, num_classes: int, hidden_size: int = 64,
                 num_layers: int = 8, num_heads: int = 1, method: str = "auto",
                 remat: bool = False, dtype: Optional[torch.dtype] = None, *, in_size: int,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.remat = remat
        self.input_proj = linear(in_size, hidden_size, generator, device)
        # GAT concatenates its heads of hidden_size; the others split hidden_size
        width = hidden_size * num_heads if conv == "gat" else hidden_size
        kw = {} if dtype is None else {"dtype": dtype}
        self.layers = nn.ModuleList(
            make_conv(conv, hidden_size if i == 0 else width, hidden_size, num_heads,
                      method=method, generator=generator, device=device, **kw)
            for i in range(num_layers))
        self.output_proj = linear(width, num_classes, generator, device)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        h = self.input_proj(x)
        for layer in self.layers:
            if self.remat:
                h = checkpoint(layer, g, h, impl, use_reentrant=False)
            else:
                h = layer(g, h, impl=impl)
        return F.log_softmax(self.output_proj(h.float()), dim=-1)


class GATNet(nn.Module):
    """Multi-layer GAT with ELU between layers (the reference's
    ``train_gatconv.py`` model): hidden layers concatenate ``num_heads``
    heads; the output layer has 1 head and slope 0.2."""

    def __init__(self, num_classes: int, hidden_size: int = 64, num_layers: int = 2,
                 num_heads: int = 4, negative_slope: float = 0.2, dropout: float = 0.0,
                 method: str = "auto", *, in_size: int, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        kw = dict(dropout=dropout, method=method, generator=generator, device=device)
        self.layers = nn.ModuleList(
            GATConv(in_size if i == 0 else hidden_size * num_heads, hidden_size, num_heads,
                    negative_slope, **kw)
            for i in range(num_layers - 1))
        self.out_layer = GATConv(hidden_size * num_heads if num_layers > 1 else in_size,
                                 num_classes, 1, **kw)

    def forward(self, g, x: torch.Tensor, impl: Optional[str] = None,
                deterministic: bool = True,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(impl=impl, deterministic=deterministic, dropout_generator=dropout_generator)
        h = x
        for layer in self.layers:
            h = F.elu(layer(g, h, **kw))
        return F.log_softmax(self.out_layer(g, h, **kw), dim=-1)
