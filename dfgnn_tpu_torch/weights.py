"""Carry a JAX ``GTModel``'s weights into the PyTorch ``GTModel``.

Takes the flax parameter tree as nested mappings of array-likes (numpy
arrays, or anything ``np.asarray`` reads), so it needs no JAX.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from dfgnn_tpu_torch.models.model import _ATOM_FEATURE_DIMS


def _plain(tree):
    """Nested mappings -> nested dicts that this module may pop from."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _take(node: dict, key: str, path: str):
    if key not in node:
        raise KeyError(f"flax params lack {path}/{key}")
    return node.pop(key)


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def _done(node: dict, path: str) -> None:
    if node:
        raise KeyError(f"flax params have unused leaves under {path}: {sorted(node)}")


def gtmodel_params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax ``GTModel`` params -> a ``state_dict`` of the torch ``GTModel``.

    Accepts the tree with or without its top-level ``"params"`` collection.
    A Dense ``kernel`` ``[din, dout]`` becomes ``Linear.weight = kernel.T``;
    an Embed ``embedding`` becomes ``Embedding.weight`` unchanged.  Every
    leaf must be used and every parameter filled, or it raises ``KeyError``.
    """
    tree = _plain(params)
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}

    def dense(node, path, prefix):
        sd[f"{prefix}.weight"] = _tensor(_take(node, "kernel", path)).T.contiguous()
        sd[f"{prefix}.bias"] = _tensor(_take(node, "bias", path))
        _done(node, path)

    def embed(node, path, prefix):
        sd[f"{prefix}.weight"] = _tensor(_take(node, "embedding", path))
        _done(node, path)

    inproj = [name for name in ("Embed_0", "Dense_0", "AtomEncoder_0") if name in tree]
    if len(inproj) != 1:
        raise KeyError(f"flax params need exactly one inproj, found {inproj}")
    name = inproj[0]
    node = tree.pop(name)
    if name == "Embed_0":
        embed(node, name, "inproj")
    elif name == "Dense_0":
        dense(node, name, "inproj")
    else:
        for i in range(len(_ATOM_FEATURE_DIMS)):
            embed(_take(node, f"atom_{i}", name), f"{name}/atom_{i}", f"inproj.atom_{i}")
        _done(node, name)

    layers = sorted(int(m.group(1)) for m in map(re.compile(r"layer_(\d+)").fullmatch, tree) if m)
    if layers != list(range(len(layers))):
        raise KeyError(f"flax layers are not numbered 0..n-1: {layers}")
    for i in layers:
        node = tree.pop(f"layer_{i}")
        for proj in ("q_proj", "k_proj", "v_proj"):
            dense(_take(node, proj, f"layer_{i}"), f"layer_{i}/{proj}", f"layers.{i}.{proj}")
        _done(node, f"layer_{i}")
    dense(_take(tree, "predictor", ""), "predictor", "predictor")
    _done(tree, "the top level")
    return sd
