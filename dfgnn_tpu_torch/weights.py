"""Carry a JAX model's weights into its PyTorch twin.

Converters for ``GTModel``, ``Model``, ``FullGraphNet``, ``GATNet`` and the
sampled trainer's ``SampledNet`` (and its ``FullNet``).  They
take the flax parameter tree as nested mappings of array-likes (numpy
arrays, or anything ``np.asarray`` reads), so they need no JAX.  A Dense
``kernel`` ``[din, dout]`` becomes ``Linear.weight = kernel.T``; an Embed
``embedding`` becomes ``Embedding.weight``; a bare leaf (GAT's ``a_l`` and
``a_r``) keeps its shape.  Every leaf must be used and every parameter
filled, or they raise ``KeyError``.
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


def _top(params) -> dict:
    """The tree as plain dicts, with or without its ``"params"`` collection."""
    tree = _plain(params)
    return tree["params"] if set(tree) == {"params"} else tree


def _dense(sd, node, path, prefix):
    sd[f"{prefix}.weight"] = _tensor(_take(node, "kernel", path)).T.contiguous()
    sd[f"{prefix}.bias"] = _tensor(_take(node, "bias", path))
    _done(node, path)


def _embed(sd, node, path, prefix):
    sd[f"{prefix}.weight"] = _tensor(_take(node, "embedding", path))
    _done(node, path)


# Each conv family's flax children: its Dense layers, then its bare leaves.
_CONV_PARAMS = {
    "gt": (("q_proj", "k_proj", "v_proj"), ()),
    "gat": (("W",), ("a_l", "a_r")),
    "agnn": (("proj",), ()),
    "dotgat": (("fc",), ()),
}


def _family(node: dict, path: str) -> str:
    """The conv family whose first Dense layer the node holds."""
    found = [conv for conv, (dense, _) in _CONV_PARAMS.items() if dense[0] in node]
    if len(found) != 1:
        raise KeyError(f"flax params under {path} are no conv layer: {sorted(node)}")
    return found[0]


def _conv(sd, node, path, prefix, conv=None):
    """One conv layer of the family ``conv`` (found from its leaves when
    None): its Dense layers and bare leaves, and nothing else."""
    dense, leaves = _CONV_PARAMS[conv or _family(node, path)]
    for key in dense:
        _dense(sd, _take(node, key, path), f"{path}/{key}", f"{prefix}.{key}")
    for key in leaves:
        sd[f"{prefix}.{key}"] = _tensor(_take(node, key, path))
    _done(node, path)


def _inproj(sd, tree):
    found = [name for name in ("Embed_0", "Dense_0", "AtomEncoder_0") if name in tree]
    if len(found) != 1:
        raise KeyError(f"flax params need exactly one inproj, found {found}")
    name = found[0]
    node = tree.pop(name)
    if name == "Embed_0":
        _embed(sd, node, name, "inproj")
    elif name == "Dense_0":
        _dense(sd, node, name, "inproj")
    else:
        for i in range(len(_ATOM_FEATURE_DIMS)):
            _embed(sd, _take(node, f"atom_{i}", name), f"{name}/atom_{i}", f"inproj.atom_{i}")
        _done(node, name)


def _layers(sd, tree, conv=None, flax_name="layer", torch_name="layers"):
    """``layer_0 .. layer_{n-1}`` -> ``layers.i`` (or other names)."""
    pattern = re.compile(flax_name + r"_(\d+)")
    layers = sorted(int(m.group(1)) for m in map(pattern.fullmatch, tree) if m)
    if layers != list(range(len(layers))):
        raise KeyError(f"flax {flax_name}s are not numbered 0..n-1: {layers}")
    for i in layers:
        _conv(sd, tree.pop(f"{flax_name}_{i}"), f"{flax_name}_{i}", f"{torch_name}.{i}", conv)


def gtmodel_params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax ``GTModel`` params -> a ``state_dict`` of the torch ``GTModel``."""
    tree = _top(params)
    sd: dict[str, torch.Tensor] = {}
    _inproj(sd, tree)
    _layers(sd, tree, "gt")
    _dense(sd, _take(tree, "predictor", ""), "predictor", "predictor")
    _done(tree, "the top level")
    return sd


_CONV_NAMES = {"GTConv_0": "gt", "GATConv_0": "gat", "AGNNConv_0": "agnn",
               "DotGATConv_0": "dotgat"}


def model_params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax ``Model`` params (an inproj and one of ``GTConv_0``,
    ``GATConv_0``, ``AGNNConv_0``, ``DotGATConv_0``) -> a torch ``Model``
    ``state_dict``."""
    tree = _top(params)
    sd: dict[str, torch.Tensor] = {}
    _inproj(sd, tree)
    found = [name for name in _CONV_NAMES if name in tree]
    if len(found) != 1:
        raise KeyError(f"flax params need exactly one conv, found {found}")
    _conv(sd, tree.pop(found[0]), found[0], "conv", _CONV_NAMES[found[0]])
    _done(tree, "the top level")
    return sd


def fullgraphnet_params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax ``FullGraphNet`` params (``input_proj``, ``layer_i``,
    ``output_proj``) -> a torch ``FullGraphNet`` ``state_dict``."""
    tree = _top(params)
    sd: dict[str, torch.Tensor] = {}
    _dense(sd, _take(tree, "input_proj", ""), "input_proj", "input_proj")
    _layers(sd, tree)
    _dense(sd, _take(tree, "output_proj", ""), "output_proj", "output_proj")
    _done(tree, "the top level")
    return sd


def gatnet_params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax ``GATNet`` params (``layer_i``, ``out_layer``) -> a torch
    ``GATNet`` ``state_dict``."""
    tree = _top(params)
    sd: dict[str, torch.Tensor] = {}
    _layers(sd, tree, "gat")
    _conv(sd, _take(tree, "out_layer", ""), "out_layer", "out_layer", "gat")
    _done(tree, "the top level")
    return sd


def sampled_net_params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax ``SampledNet`` (or ``FullNet``) params of the sampled trainer
    (``Dense_0``, ``conv_i`` GT layers, ``Dense_1``) -> a ``state_dict`` of
    :class:`dfgnn_tpu_torch.scripts.train_sampled.SampledNet`."""
    tree = _top(params)
    sd: dict[str, torch.Tensor] = {}
    _dense(sd, _take(tree, "Dense_0", ""), "Dense_0", "input_proj")
    _layers(sd, tree, "gt", flax_name="conv", torch_name="convs")
    _dense(sd, _take(tree, "Dense_1", ""), "Dense_1", "output_proj")
    _done(tree, "the top level")
    return sd
