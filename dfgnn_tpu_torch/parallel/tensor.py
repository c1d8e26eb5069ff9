"""Tensor (model) parallelism: attention sharded over heads.

The counterpart of :mod:`dfgnn_tpu.parallel.tensor`.  Every head's SDDMM ->
softmax -> SpMM is independent, so sharding the head dim over a ``"model"``
mesh axis runs the whole conv with no collective inside it; the projections'
weights shard on their output features (column parallelism).  Composes with
data parallelism on a 2-D ``("data", "model")`` mesh and with any graph
layout, which every rank holds whole.

As everywhere in the port's multi-device layer, a rank returns its own
block: :func:`head_sharded_attention` gives this rank's heads of the output,
and :func:`shard_params_tp` this rank's columns of the weights.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.ops import graph_attention
from dfgnn_tpu_torch.parallel.dist import mesh_group_rank


def make_tp_mesh(n_data: int, n_model: int, axis_names=("data", "model"),
                 device="cuda") -> DeviceMesh:
    """A 2-D mesh of the first ``n_data * n_model`` ranks, model-major inside
    each data row (ranks ``d * n_model .. d * n_model + n_model - 1`` form
    data row ``d``)."""
    dev = resolve_device(device)
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))


def _heads(mesh: DeviceMesh, axis: str, h: int):
    n_model = mesh.size(mesh.mesh_dim_names.index(axis))
    if h % n_model:
        raise ValueError(f"heads={h} not divisible by model axis {n_model}")
    _, r = mesh_group_rank(mesh, axis)
    per = h // n_model
    return slice(r * per, (r + 1) * per)


def head_sharded_attention(
    mesh: DeviceMesh,
    g,
    q: Optional[torch.Tensor],
    k: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    axis: str = "model",
    **kw,
) -> torch.Tensor:
    """:func:`~dfgnn_tpu_torch.ops.graph_attention` on this rank's slice of
    the heads.  ``q, k, v`` (and ``e_row``, ``e_col`` in ``kw``) hold all
    heads, on the head dim (``[B, P, h, f]`` on a DenseBatch, ``[n, h, f]``
    elsewhere); the heads must divide by the size of ``axis``.  Returns this
    rank's heads of the output, ``[..., h / n_model, f]``; each rank runs the
    usual single-device path for the layout (the flash kernels, the bucket
    path or the oracle), with no collective."""
    hs = _heads(mesh, axis, v.shape[-2])
    # each rank's heads are a tensor of their own, as a shard_map shard is
    # (the flash kernels take contiguous operands)
    cut = lambda x: None if x is None else x[..., hs, :].contiguous()
    for name in ("e_row", "e_col"):
        if kw.get(name) is not None:
            kw[name] = kw[name][..., hs].contiguous()
    return graph_attention(g, cut(q), cut(k), cut(v), **kw)


_TP_NAMES = ("q_proj", "k_proj", "v_proj", "W")


def shard_params_tp(params: dict, mesh: DeviceMesh, axis: str = "model") -> dict:
    """This rank's column block of every 2-D projection weight whose name
    holds ``q_proj``, ``k_proj``, ``v_proj`` or ``W`` (Megatron-style column
    parallelism), and every other entry as it is (replicated).  The column
    is the output-feature dim: the first of a torch ``nn.Linear`` weight
    (a name ending in ``.weight``), the last of an ``[in, out]`` matrix."""
    out = {}
    for name, x in params.items():
        if x.ndim == 2 and any(s in name for s in _TP_NAMES):
            dim = 0 if name.endswith(".weight") else 1
            hs = _heads(mesh, axis, x.shape[dim])
            x = x[hs] if dim == 0 else x[:, hs]
        out[name] = x
    return out
