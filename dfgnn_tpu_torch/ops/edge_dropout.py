"""Stateless per-edge dropout mask, a copy of :mod:`dfgnn_tpu.ops.edge_dropout`.

The mask is a pure function of the edge identity: a murmur3-style integer
hash of ``(seed, dst, src, head)``, so the forward and backward kernels
regenerate the same mask from the seed and no mask is stored.  The values
are bitwise equal to the JAX package's for the same uint32 seed.

This torch build's uint32 tensors have no ``>>`` and no ``>=``, so the hash
runs on int64 tensors holding values in ``[0, 2**32)``.  A product of two
32-bit values would overflow int64, so :func:`_mul32` multiplies by the
16-bit halves of the constant: every partial product stays under ``2**48``.
``csrc/flash_common.cuh`` holds the same hash in ``uint32_t`` for the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_P3 = 0xC2B2AE3D


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit
    constant ``m``, with no partial product at or above ``2**48``."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _u32(x, device) -> torch.Tensor:
    """An id (int or int tensor) as int64 holding its uint32 value."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK32


def seed_from_generator(gen: torch.Generator) -> int:
    """One uint32 seed drawn on the host from a CPU ``torch.Generator``.

    The counterpart of the JAX package's ``seed_from_key``; the draw never
    touches the card, so it costs no device synchronisation.
    """
    if gen.device.type != "cpu":
        raise ValueError(f"the dropout seed is drawn from a CPU generator, not one on "
                         f"{gen.device}")
    return int(torch.randint(0, 2 ** 32, (), generator=gen, dtype=torch.int64))


def edge_hash(seed, dst, src, head) -> torch.Tensor:
    """uint32 hash over broadcastable int ids, as int64 in ``[0, 2**32)``.

    ``dst``, ``src`` and ``head`` are ints or int tensors; ids are taken
    modulo ``2**32``, as the JAX package's ``astype(uint32)`` takes them.
    """
    device = next((t.device for t in (dst, src, head) if isinstance(t, torch.Tensor)), None)
    h = _u32(seed, device)
    h = _mix(h ^ _mul32(_u32(dst, device), _P1))
    h = _mix(h ^ _mul32(_u32(src, device), _P2))
    return _mix(h ^ _mul32(_u32(head, device), _P3))


def keep_threshold(rate: float) -> int:
    """Edges with ``hash >= threshold`` are kept (drop probability = rate)."""
    return min(int(rate * 4294967296.0), 4294967295)


def drop_scale(rate: float) -> float:
    """``1 / (1 - rate)`` computed in double and rounded to fp32, as the JAX
    package's weak-typed multiply rounds it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def keep_scale(seed, dst, src, head, rate: float, dtype=torch.float32) -> torch.Tensor:
    """``keep / (1 - rate)`` per (edge, head): multiply it into the
    numerator attention weights only (the denominator stays undropped)."""
    keep = edge_hash(seed, dst, src, head) >= keep_threshold(rate)
    return keep.to(dtype) * drop_scale(rate)
