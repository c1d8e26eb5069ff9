"""Model assembly: input projections, pooling, the graph-level GTModel.

The counterpart of :mod:`dfgnn_tpu.models.model` for the serving slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models.conv import GTConv, linear

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
    if not isinstance(g, DenseBatch):
        raise NotImplementedError(
            f"graph_pool on {type(g).__name__} is not ported yet: only DenseBatch is "
            "(ROADMAP.md queue 1 items 4 and 7)")
    xb = x.reshape(g.n_graphs, g.np_pad, -1)
    mask = g.node_mask[..., None]
    s = torch.where(mask, xb, 0.0).sum(dim=1)
    if op == "sum":
        return s
    if op == "mean":
        cnt = g.node_mask.sum(dim=1, keepdim=True).clamp_min(1)
        return s / cnt
    raise ValueError(op)


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
