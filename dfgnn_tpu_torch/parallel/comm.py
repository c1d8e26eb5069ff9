"""The collectives of the multi-device layer, each with its transpose.

The counterparts of the ``jax.lax`` collectives that the JAX package calls
inside ``shard_map`` (``dfgnn_tpu/parallel/partition.py``):

=============================  ==========================  ===============================
JAX                            here                        backward
=============================  ==========================  ===============================
``all_to_all`` (tiled)         :func:`all_to_all`          the reverse all-to-all
``all_gather`` (tiled)         :func:`all_gather`          reduce-scatter of the cotangent
``psum``                       :func:`all_reduce_sum`      sum all-reduce of the cotangent
``pmax`` of a stop_gradient    :func:`all_reduce_max`      none (no autograd)
=============================  ==========================  ===============================

With rank-local inputs the loss of a step is the sum of the ranks' losses,
so a collective's backward is its transpose over all ranks: the all-gather's
backward reduce-scatters the partial cotangents of every rank (taking only
the local slice would drop what the other ranks' rows contributed).  Each is
a :class:`torch.autograd.Function` of its own rather than
``torch.distributed.nn.functional``, whose all-gather returns a list and whose
all-reduce's backward has differed between releases.

Every function takes its process group explicitly; there is no default.  The
backend is the group's: :func:`default_backend` names ``nccl`` for CUDA
tensors and ``gloo`` for CPU ones, and an explicit ``backend=`` where a group
is made overrides it.  Nothing switches backends after a failure.  gloo takes
CUDA tensors for every collective here (probed on an H100 with torch 2.11:
all-to-all, all-gather, all-reduce sum and max, reduce-scatter, broadcast), so
no branch stages through host memory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n_ranks, ...]: block ``e`` goes to rank ``e``; returns the
    blocks received, [n_ranks (sender), ...]."""
    x = x.contiguous()
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x, group=group)
    return y


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    y = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(y, x, group=group)
    return y


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    y = x.new_empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]))
    dist.reduce_scatter_tensor(y, x, op=dist.ReduceOp.SUM, group=group)
    return y


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all of ``x`` [n_ranks, ...] (block ``e`` to rank
    ``e``); returns [n_ranks (sender), ...].  Backward: the reverse
    all-to-all."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0, in rank order.  Backward:
    the sum reduce-scatter of the cotangent."""
    return _AllGather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks (``psum``).  Backward: the sum
    all-reduce of the cotangent."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks, outside autograd: the
    cross-device softmax shift, a pure numerical shift whose gradient is
    zero (JAX's ``all_gather`` of a ``stop_gradient``)."""
    with torch.no_grad():
        return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` overwritten in place, outside autograd, by the group's rank
    ``src`` (a rank of ``group``, not a global rank)."""
    with torch.no_grad():
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x
