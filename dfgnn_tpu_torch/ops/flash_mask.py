"""Masked dense flash attention over a :class:`DenseBatch`, forward and backward.

The counterpart of :mod:`dfgnn_tpu.ops.pallas.flash_mask`.  Its six Pallas
kernels become hand-written CUDA kernels, built with ``nvcc`` for ``sm_90a``
into one library at first use (:mod:`dfgnn_tpu_torch.ops._cuda`) and bound
with ``ctypes``:

    _fwd_kernel_dot    (#1)  csrc/flash_mask_fwd.cu   flash_mask_fwd
    _bwd_kernel_dot    (#3)  csrc/flash_mask_bwd.cu   flash_mask_bwd
    _fwd_kernel_add    (#2)  csrc/flash_add_fwd.cu    flash_add_fwd
    _bwd_kernel_add    (#4)  csrc/flash_add_bwd.cu    flash_add_bwd
    _layer_kernel_dot  (#5)  csrc/flash_layer_dot.cu  flash_layer_dot_fwd
    _layer_kernel_add  (#6)  csrc/flash_layer_add.cu  flash_layer_add_fwd

For tensors on the CPU each wrapper runs its ``*_plain`` twin, the same
function in plain PyTorch; for CUDA tensors it launches its kernel or
raises.  It never falls back.  :class:`_FlashDot` and :class:`_FlashAdd` tie
#1/#3 and #2/#4 into autograd on every device; :class:`_FlashLayerDot` and
:class:`_FlashLayerAdd` run the whole-layer kernels forward and recompute
their backward as torch ops around #1 and #3, or #2 and #4.  Kernels #1 to
#4 and #6 take the per-edge dropout of
:mod:`dfgnn_tpu_torch.ops.edge_dropout`.

``precision`` is the JAX package's: None is ``"highest"`` for fp32 and
``"default"`` for bf16.  ``"highest"`` runs the kernels' fp32 products as
3xTF32 (rtol 1e-4 of fp32); ``"default"`` on fp32 inputs runs each as one
TF32 pass (the operands rounded to TF32, as ``cvt.rna.tf32`` rounds them),
the card's counterpart of one bf16 pass on the TPU, and the plain versions
round the same operands the same way.  bf16 products are exact in fp32, so
bf16 inputs ignore it.  The torch ops around the kernels (the whole-layer
backward's projection gradients, the dense formulation) stay fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import _cuda, edge_dropout
from dfgnn_tpu_torch.ops.dense_block import NEG_BIG

DEAD = 0.5 * NEG_BIG  # row-max clamp: exp(s - m) underflows to 0 on masked lanes

# What the kernels take: any head dim f >= 1 (the tiles are zero past f; #1,
# #2 and #3 past 256 in wide blocks that form the scores once per 512
# columns, #4 in chunks of 256 columns, #5 and #6 past 256 in chunks of 128)
# and any node count P >= 1 (past 2048 their blocks walk adj in windows of
# 2048 keys or rows, so their shared memory stays that of P = 2048); their
# in-graph offsets are 64-bit, so no P is refused.
PRECISIONS = ("highest", "default")
# #4 at P > KERNEL_KEYS: each block of this many keys writes its share of
# d e_row into scratch, summed by a second launch (csrc/flash_add_bwd.cu)
KERNEL_KEYS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches per wrapper call, one each (a backward call runs two passes);
# callers may reset them to 0.
LAUNCHES = 0  # kernel #1, by flash_mask_fwd
BWD_LAUNCHES = 0  # kernel #3, by flash_mask_bwd
ADD_LAUNCHES = 0  # kernel #2, by flash_add_fwd
ADD_BWD_LAUNCHES = 0  # kernel #4, by flash_add_bwd
LAYER_LAUNCHES = 0  # kernel #5, by flash_layer_dot_fwd
LAYER_ADD_LAUNCHES = 0  # kernel #6, by flash_layer_add_fwd


def launch_counts() -> tuple[int, int, int, int, int, int]:
    """Launches of kernels #1, #3, #2, #4, #5 and #6 since their counts were
    last reset."""
    return (LAUNCHES, BWD_LAUNCHES, ADD_LAUNCHES, ADD_BWD_LAUNCHES, LAYER_LAUNCHES,
            LAYER_ADD_LAUNCHES)


def reset_launch_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES, ADD_LAUNCHES, ADD_BWD_LAUNCHES
    global LAYER_LAUNCHES, LAYER_ADD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = ADD_LAUNCHES = ADD_BWD_LAUNCHES = 0
    LAYER_LAUNCHES = LAYER_ADD_LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library with the argument types of kernels #1 to #6."""
    lib = _cuda.library()
    vp, i = ctypes.c_void_p, ctypes.c_int
    f, u = ctypes.c_float, ctypes.c_uint32
    dot_drop = [i, u, u, f]  # drop, seed, threshold, scale
    # every entry ends with one_pass (precision "default" on fp32) and the stream
    lib.dfgnn_flash_mask_fwd.argtypes = [i, *[vp] * 7, i, i, i, i, *dot_drop, i, vp]
    lib.dfgnn_flash_mask_fwd.restype = i
    lib.dfgnn_flash_mask_bwd.argtypes = [i, *[vp] * 12, i, i, i, i, *dot_drop, i, vp]
    lib.dfgnn_flash_mask_bwd.restype = i
    drop = [f, *dot_drop]  # slope, drop, seed, threshold, scale
    lib.dfgnn_flash_add_fwd.argtypes = [i, *[vp] * 7, i, i, i, i, *drop, i, vp]
    lib.dfgnn_flash_add_fwd.restype = i
    lib.dfgnn_flash_add_bwd.argtypes = [i, *[vp] * 12, i, i, i, i, *drop, i, vp]
    lib.dfgnn_flash_add_bwd.restype = i
    lib.dfgnn_flash_layer_dot_fwd.argtypes = [i, *[vp] * 10, ctypes.c_longlong, i, i, i, i, i,
                                              f, i, vp]
    lib.dfgnn_flash_layer_dot_fwd.restype = i
    lib.dfgnn_flash_layer_add_fwd.argtypes = [i, *[vp] * 8, i, i, i, i, i, *drop, i, vp]
    lib.dfgnn_flash_layer_add_fwd.restype = i
    return lib


def _acc(t):
    """``t`` in the plain versions' arithmetic type: fp64 stays fp64 (an
    exact evaluation to hold the kernels against), everything else is fp32."""
    return t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def resolve_precision(precision: Optional[str], dtype: torch.dtype) -> str:
    """``precision`` as the JAX package's ``_resolve_precision`` reads it:
    None is ``"default"`` for bf16 and ``"highest"`` otherwise (fp64, the
    plain versions' exact evaluation, reads as fp32); anything but
    ``"highest"`` and ``"default"`` raises."""
    if precision is None:
        return "default" if dtype == torch.bfloat16 else "highest"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be None, 'highest' or 'default', not {precision!r}")
    return precision


def _one_pass(precision: Optional[str], dtype: torch.dtype) -> bool:
    """Whether the products of ``dtype`` operands run as one TF32 pass:
    ``"default"`` on anything but bf16, whose products are exact in fp32."""
    return resolve_precision(precision, dtype) == "default" and dtype != torch.bfloat16


def round_tf32(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32`` and the kernels' ``round_tf32`` round a
    product's operand, in the plain versions' arithmetic type (fp64 inputs
    round through fp32).  Finite values only."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(_acc(t).dtype)


def _mm(t, tf32: bool):
    """A product's operand in the plain versions' arithmetic type, rounded
    to TF32 when ``tf32`` (one pass, precision "default")."""
    return round_tf32(t) if tf32 else _acc(t)


def _softmax_matmul_plain(s, adj, v, val, drop, tf32=False):
    """``_softmax_matmul`` of the Pallas kernels on fp32 scores ``[B, h, P, P]``.

    Scales ``s`` by ``val``, masks it with ``adj``, and returns ``out``
    ``[B, P, h, f]`` in v's dtype and ``lse`` ``[h, B, P]`` fp32.  ``drop``
    (a ``[B, h, P, P]`` factor or None) multiplies the undropped ``ex`` after
    its row sum; ``ex`` is rounded to v's dtype before the product (and
    both operands to TF32 with ``tf32``).
    """
    if val is not None:
        s = s * _acc(val[:, None])
    s = torch.where(adj[:, None].bool(), s, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEAD)
    ex = torch.exp(s - m)
    l = ex.sum(dim=-1, keepdim=True)
    has = l > 0
    inv = torch.where(has, 1.0 / torch.where(has, l, 1.0), 0.0)
    if drop is not None:
        ex = ex * drop
    out = torch.einsum("bhrc,bchf->brhf", _mm(ex.to(v.dtype), tf32), _mm(v, tf32))
    out = (out * inv.transpose(1, 2)).to(v.dtype)
    lse = torch.where(has, m + torch.log(torch.where(has, l, 1.0)), NEG_BIG)
    return out, lse[..., 0].permute(1, 0, 2)


def flash_mask_fwd_plain(q, k, v, adj, val=None, *, seed: int = 0, rate: float = 0.0,
                         precision: Optional[str] = None):
    """Kernel #1's function in plain PyTorch, on any device.

    ``q, k, v``: ``[B, P, h, f]`` (q pre-scaled); ``adj``: ``[B, P, P]``;
    ``val``: ``[B, P, P]`` or None.  Returns ``out`` ``[B, P, h, f]`` in v's
    dtype and ``lse`` ``[h, B, P]`` fp32.  Scores and sums are fp32; ``ex``
    is rounded to v's dtype before the product, as in the Pallas kernel.
    ``rate > 0`` drops the numerator weights with the edge hash of ``seed``;
    ``lse`` does not see dropout.  fp64 inputs evaluate in fp64 throughout,
    the exact reference the card tests hold the kernel to.  ``precision=
    "default"`` rounds both operands of each product to TF32 first
    (:func:`round_tf32`), as the kernel's one pass does.
    """
    tf32 = _one_pass(precision, v.dtype)
    s = torch.einsum("brhf,bchf->bhrc", _mm(q, tf32), _mm(k, tf32))
    B, P, h, _ = v.shape
    drop = dropout_factor(seed, rate, B, h, P, v.device) if rate > 0.0 else None
    return _softmax_matmul_plain(s, adj, v, val, drop, tf32)


def dropout_factor(seed: int, rate: float, B: int, h: int, P: int, device) -> torch.Tensor:
    """The kernels' dropout factor ``keep / (1 - rate)`` ``[B, h, P, P]`` fp32,
    keyed as the Pallas kernels' ``_drop_scale``: dst = g*P + r,
    src = g*P + c, head = h."""
    g = torch.arange(B, device=device).view(B, 1, 1, 1) * P
    r = torch.arange(P, device=device).view(1, 1, P, 1)
    c = torch.arange(P, device=device).view(1, 1, 1, P)
    hh = torch.arange(h, device=device).view(1, h, 1, 1)
    return edge_dropout.keep_scale(seed, g + r, g + c, hh, rate)


def _add_scores(e_row, e_col, slope):
    """``pre = e_row[r] + e_col[c]`` and ``leaky_relu(pre)``, ``[B, h, P, P]``
    fp32 (fp64 for fp64 scalars), from node-major ``[B, P, h]`` scalars."""
    pre = (_acc(e_row).permute(0, 2, 1)[..., :, None]
           + _acc(e_col).permute(0, 2, 1)[..., None, :])
    return pre, torch.where(pre >= 0, pre, pre * slope)


def flash_add_fwd_plain(e_row, e_col, v, adj, val=None, *, slope: float = 0.2,
                        seed: int = 0, rate: float = 0.0, precision: Optional[str] = None):
    """Kernel #2's function in plain PyTorch, on any device.

    ``e_row, e_col``: ``[B, P, h]``; ``v``: ``[B, P, h, f]``; ``adj``,
    ``val``: as :func:`flash_mask_fwd_plain`'s.  Scores are
    ``leaky_relu(e_row[r] + e_col[c])`` in fp32; ``rate > 0`` drops the
    numerator weights with the edge hash of ``seed``.  Returns ``(out, lse)``
    as :func:`flash_mask_fwd_plain` does; ``lse`` does not see dropout.
    ``precision`` as :func:`flash_mask_fwd_plain`'s, on ex . v.
    """
    _, s = _add_scores(e_row, e_col, slope)
    B, P, h, _ = v.shape
    drop = dropout_factor(seed, rate, B, h, P, v.device) if rate > 0.0 else None
    return _softmax_matmul_plain(s, adj, v, val, drop, _one_pass(precision, v.dtype))


def bwd_delta(do, out):
    """``delta = rowsum(dO * out)`` ``[h, B, P]`` fp32: the backward's input
    that stays outside its kernel, as in the JAX package's ``_bwd``."""
    return (_acc(do) * _acc(out)).sum(dim=-1).permute(2, 0, 1).contiguous()


def flash_mask_bwd_plain(q, k, v, adj, val, lse, do, delta, *, seed: int = 0,
                         rate: float = 0.0, precision: Optional[str] = None):
    """The backward kernel's function in plain PyTorch, on any device.

    ``q, k, v, do``: ``[B, P, h, f]``; ``adj``, ``val``: as the forward's;
    ``lse``, ``delta``: ``[h, B, P]`` fp32; ``seed`` and ``rate``: the
    forward's dropout, whose factor multiplies ``dp`` and ``p`` for dv.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k and v.  Scores, ``p`` and
    ``ds`` are fp32; ``ds`` and ``p * keep`` are rounded to the input dtype
    before the products, as in the Pallas kernel.  Empty rows (lse = -1e30,
    no edges) give p = 0.  fp64 inputs evaluate in fp64 throughout.
    ``precision`` as :func:`flash_mask_fwd_plain`'s, on all five products.
    """
    tf32 = _one_pass(precision, v.dtype)
    mm = lambda t: _mm(t, tf32)
    s = torch.einsum("brhf,bchf->bhrc", mm(q), mm(k))
    if val is not None:
        s = s * _acc(val[:, None])
    edge = adj[:, None].bool()
    lse_b = lse.permute(1, 0, 2)[..., None]      # [B, h, P, 1]
    delta_b = delta.permute(1, 0, 2)[..., None]
    p = torch.where(edge, torch.exp(torch.where(edge, s - lse_b, 0.0)), 0.0)
    dp = torch.einsum("brhf,bchf->bhrc", mm(do), mm(v))
    pn = p
    if rate > 0.0:
        B, P, h, _ = v.shape
        keep = dropout_factor(seed, rate, B, h, P, v.device)
        dp, pn = dp * keep, p * keep
    ds = p * (dp - delta_b)
    if val is not None:
        ds = ds * _acc(val[:, None])
    dq = torch.einsum("bhrc,bchf->brhf", mm(ds.to(k.dtype)), mm(k))
    dk = torch.einsum("bhrc,brhf->bchf", mm(ds.to(q.dtype)), mm(q))
    dv = torch.einsum("bhrc,brhf->bchf", mm(pn.to(do.dtype)), mm(do))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_add_bwd_plain(e_row, e_col, v, adj, val, lse, do, delta, *, slope: float = 0.2,
                        seed: int = 0, rate: float = 0.0, precision: Optional[str] = None):
    """Kernel #4's function in plain PyTorch, on any device.

    Inputs as :func:`flash_add_fwd_plain`'s, with the forward's ``lse`` and
    ``delta`` = rowsum(dO * out) ``[h, B, P]`` fp32.  Returns
    ``(d e_row, d e_col, dv)`` in the dtypes of e_row, e_col and v.  ``dp``
    and ``p`` take the same dropout factor; leaky' tests the pre-val sum;
    ``p * keep`` is rounded to dO's dtype before its product.  ``precision``
    as :func:`flash_mask_fwd_plain`'s, on dp and dv.  fp64 inputs evaluate
    in fp64 throughout.
    """
    tf32 = _one_pass(precision, v.dtype)
    mm = lambda t: _mm(t, tf32)
    pre, s = _add_scores(e_row, e_col, slope)
    if val is not None:
        s = s * _acc(val[:, None])
    edge = adj[:, None].bool()
    lse_b = lse.permute(1, 0, 2)[..., None]      # [B, h, P, 1]
    delta_b = delta.permute(1, 0, 2)[..., None]
    p = torch.where(edge, torch.exp(torch.where(edge, s - lse_b, 0.0)), 0.0)
    dp = torch.einsum("brhf,bchf->bhrc", mm(do), mm(v))
    pn = p
    if rate > 0.0:
        B, P, h, _ = v.shape
        keep = dropout_factor(seed, rate, B, h, P, v.device)
        dp, pn = dp * keep, p * keep
    ds = p * (dp - delta_b)
    if val is not None:
        ds = ds * _acc(val[:, None])
    dpre = torch.where(pre >= 0, ds, ds * slope)
    der = dpre.sum(dim=-1).permute(0, 2, 1).contiguous()  # [B, P, h]
    dec = dpre.sum(dim=-2).permute(0, 2, 1).contiguous()
    dv = torch.einsum("bhrc,brhf->bchf", mm(pn.to(do.dtype)), mm(do))
    return der.to(e_row.dtype), dec.to(e_col.dtype), dv.to(v.dtype)


def _check_block_args(v, adj, val, score: str = "add", **named):
    """What kernels #1 to #4 take, either ``score``: fp32 or bf16 ``v``
    ``[B, P, h, f]`` with f >= 1 and P >= 1, uint8 ``adj`` and
    fp32 ``val`` ``[B, P, P]``, all on v's device; ``v``, ``adj``, ``val``
    and the ``named`` tensors contiguous."""
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes fp32 or bf16, not {v.dtype}")
    if v.dim() != 4:
        raise ValueError(f"v must be [B, P, h, f], got {tuple(v.shape)}")
    B, P, h, f = v.shape
    if not flash_takes(score, P, f) or B < 1 or h < 1:
        kernels = "#1 and #3" if score == "dot" else "#2 and #4"
        raise ValueError(f"kernels {kernels} take B, P, h, f >= 1, got B={B} P={P} h={h} f={f}")
    if adj.dtype != torch.uint8 or adj.shape != (B, P, P) or adj.device != v.device:
        raise ValueError("adj must be uint8 [B, P, P] on v's device")
    if val is not None and (val.dtype != torch.float32 or val.shape != (B, P, P)
                            or val.device != v.device):
        raise ValueError("val must be fp32 [B, P, P] on v's device")
    for name, t in (("v", v), ("adj", adj), ("val", val), *named.items()):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dropout(seed, rate):
    if not 0.0 <= rate < 1.0 or not 0 <= seed < 2 ** 32:
        raise ValueError(f"dropout takes 0 <= rate < 1 and a uint32 seed, got {rate}, {seed}")


def _check_kernel_args(q, k, v, adj, val, seed, rate):
    for name, t in (("q", q), ("k", k)):
        if t.dtype != v.dtype or t.shape != v.shape or t.device != v.device:
            raise ValueError(f"{name} must match v in dtype, shape and device")
    _check_block_args(v, adj, val, score="dot", q=q, k=k)
    _check_dropout(seed, rate)


def _check_add_args(e_row, e_col, v, adj, val, seed, rate):
    if v.dim() == 4:
        for name, t in (("e_row", e_row), ("e_col", e_col)):
            if (t.dtype not in (torch.float32, v.dtype) or t.shape != v.shape[:3]
                    or t.device != v.device):
                raise ValueError(f"{name} must be [B, P, h] of fp32 or v's dtype on v's device")
    _check_block_args(v, adj, val, e_row=e_row, e_col=e_col)
    _check_dropout(seed, rate)


def _dropout_args(seed: int, rate: float) -> list:
    """The kernels' dropout arguments: on, seed, threshold, fp32 scale."""
    if rate <= 0.0:
        return [0, 0, 0, 1.0]
    return [1, seed, edge_dropout.keep_threshold(rate), edge_dropout.drop_scale(rate)]


def flash_mask_fwd(q, k, v, adj, val=None, *, seed: int = 0, rate: float = 0.0,
                   want_lse: bool = False, precision: Optional[str] = None):
    """Masked attention forward: ``(out [B, P, h, f], lse [h, B, P] | None)``.

    CPU tensors run :func:`flash_mask_fwd_plain`.  CUDA tensors launch the
    kernel on the current stream: fp32 or bf16 ``q, k, v`` of one shape,
    contiguous, any P, f >= 1; uint8 ``adj``; fp32 ``val`` or None;
    ``0 <= rate < 1`` and a uint32 ``seed``; ``precision`` None,
    ``"highest"`` or ``"default"`` (one TF32 pass on fp32).  Anything else
    raises.
    """
    if q.device.type == "cpu":
        out, lse = flash_mask_fwd_plain(q, k, v, adj, val, seed=seed, rate=rate,
                                        precision=precision)
        return out, (lse if want_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_mask_fwd kernel for device {q.device}")
    _check_kernel_args(q, k, v, adj, val, seed, rate)
    one = _one_pass(precision, q.dtype)
    B, P, h, f = q.shape
    out = torch.empty_like(v)
    lse = (torch.empty((h, B, P), dtype=torch.float32, device=q.device)
           if want_lse else None)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.dfgnn_flash_mask_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            adj.data_ptr(), None if val is None else val.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, P, h, f, *_dropout_args(seed, rate), int(one),
            torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "flash_mask_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def bwd_forms_delta(P: int, f: int) -> bool:
    """Whether kernel #3 forms ``delta`` itself, from the forward's ``out``:
    its whole-graph wide block (P <= 128, f > 256) reads dO and out once per
    row in place of the wrapper's product and sum (:func:`bwd_delta`); every
    other block takes delta from the wrapper.  The C entry point keeps the
    same rule and refuses a null delta or out where it reads one, so a
    disagreement raises."""
    return f > 256 and P <= 128


def flash_mask_bwd(q, k, v, adj, val, out, lse, do, *, seed: int = 0, rate: float = 0.0,
                   precision: Optional[str] = None):
    """Masked attention backward: ``(dq, dk, dv)`` ``[B, P, h, f]``.

    ``out`` and ``lse`` are the forward's (``out`` with dropout applied, for
    ``delta``); ``do`` is the output's gradient; ``seed`` and ``rate`` the
    forward's dropout and ``precision`` its precision.  On CPU tensors
    computes ``delta`` (:func:`bwd_delta`) and runs
    :func:`flash_mask_bwd_plain`; on CUDA tensors computes it too, unless the
    kernel forms it (:func:`bwd_forms_delta`), and launches the kernel (one C
    call) on the current stream.  The kernel takes what the forward kernel
    takes, with ``out`` and ``do`` of q's dtype and shape, ``do``
    contiguous, and ``lse`` fp32 ``[h, B, P]``; anything else raises.  Past
    f = 256 the C call runs the wide blocks: at P <= 128 one block per
    (graph, head) forms delta (from ``out``, :func:`bwd_forms_delta`), then
    s, p, dp and ds once over column chunks, keeps ds and pn in shared
    memory and forms dq, dk and dv chunk by chunk (five products, each
    once); past it a row pass (dq) and a column pass (dk and dv together),
    each forming s and dp once per tile and 512 columns of its outputs.
    """
    if q.device.type == "cpu":
        return flash_mask_bwd_plain(q, k, v, adj, val, lse, do, bwd_delta(do, out), seed=seed,
                                    rate=rate, precision=precision)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_mask_bwd kernel for device {q.device}")
    _check_kernel_args(q, k, v, adj, val, seed, rate)
    one = _one_pass(precision, q.dtype)
    for name, t in (("out", out), ("do", do)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must match q in dtype, shape and device")
    if not do.is_contiguous():
        raise ValueError("do must be contiguous")
    B, P, h, f = q.shape
    if lse.dtype != torch.float32 or lse.shape != (h, B, P) or lse.device != q.device:
        raise ValueError("lse must be fp32 [h, B, P] on q's device")
    lse = lse.contiguous()  # a row per (head, graph, node): a cheap copy when strided
    # out is read by bwd_delta, through its strides, or by the kernel, which
    # forms delta itself (contiguous: a copy of a strided out on that path)
    if bwd_forms_delta(P, f):
        delta, out = None, out.contiguous()
    else:
        delta, out = bwd_delta(do, out), None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.dfgnn_flash_mask_bwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            adj.data_ptr(), None if val is None else val.data_ptr(), lse.data_ptr(),
            None if delta is None else delta.data_ptr(), None if out is None else out.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, P, h, f, *_dropout_args(seed, rate), int(one),
            torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "flash_mask_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


def flash_add_fwd(e_row, e_col, v, adj, val=None, *, slope: float = 0.2, seed: int = 0,
                  rate: float = 0.0, want_lse: bool = False, precision: Optional[str] = None):
    """Additive-score attention forward: ``(out [B, P, h, f], lse [h, B, P] | None)``.

    CPU tensors run :func:`flash_add_fwd_plain`.  CUDA tensors launch kernel
    #2 on the current stream: fp32 or bf16 ``v``, contiguous, any head dim
    f >= 1; ``e_row, e_col`` ``[B, P, h]`` contiguous, fp32 or v's dtype (the
    kernel reads fp32, as the Pallas kernel does, so bf16 scalars are
    widened exactly); ``adj``, ``val`` as :func:`flash_mask_fwd` takes them;
    ``0 <= rate < 1`` and a uint32 ``seed``; ``precision`` as
    :func:`flash_mask_fwd`'s.  Anything else raises.
    """
    if v.device.type == "cpu":
        out, lse = flash_add_fwd_plain(e_row, e_col, v, adj, val, slope=slope, seed=seed,
                                       rate=rate, precision=precision)
        return out, (lse if want_lse else None)
    if v.device.type != "cuda":
        raise ValueError(f"no flash_add_fwd kernel for device {v.device}")
    _check_add_args(e_row, e_col, v, adj, val, seed, rate)
    one = _one_pass(precision, v.dtype)
    e_row, e_col = e_row.float(), e_col.float()
    B, P, h, f = v.shape
    out = torch.empty_like(v)
    lse = (torch.empty((h, B, P), dtype=torch.float32, device=v.device)
           if want_lse else None)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.dfgnn_flash_add_fwd(
            _DTYPE_CODES[v.dtype], e_row.data_ptr(), e_col.data_ptr(), v.data_ptr(),
            adj.data_ptr(), None if val is None else val.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, P, h, f, slope,
            *_dropout_args(seed, rate), int(one), torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "flash_add_fwd")
    global ADD_LAUNCHES
    ADD_LAUNCHES += 1
    return out, lse


def flash_add_bwd(e_row, e_col, v, adj, val, out, lse, do, *, slope: float = 0.2,
                  seed: int = 0, rate: float = 0.0, precision: Optional[str] = None):
    """Additive-score attention backward: ``(d e_row, d e_col, dv)``.

    ``out`` and ``lse`` are the forward's (``out`` with dropout applied, for
    ``delta``); ``do`` is the output's gradient.  Computes ``delta``
    (:func:`bwd_delta`), then on CPU tensors runs :func:`flash_add_bwd_plain`
    and on CUDA tensors launches kernel #4 (one C call; at P > KERNEL_KEYS
    a second launch sums the key blocks' shares of d e_row) with the
    forward's seed, rate and precision.  The kernel takes what :func:`flash_add_fwd`'s
    takes, with ``out`` and ``do`` of v's dtype and shape, ``do`` contiguous
    and ``lse`` fp32 ``[h, B, P]``; anything else raises.  ``d e_row`` and
    ``d e_col`` are fp32 sums returned in the scalars' own dtype, as the JAX
    package's VJP returns them.
    """
    kw = dict(slope=slope, seed=seed, rate=rate, precision=precision)
    if v.device.type == "cpu":
        return flash_add_bwd_plain(e_row, e_col, v, adj, val, lse, do, bwd_delta(do, out), **kw)
    if v.device.type != "cuda":
        raise ValueError(f"no flash_add_bwd kernel for device {v.device}")
    _check_add_args(e_row, e_col, v, adj, val, seed, rate)
    one = _one_pass(precision, v.dtype)
    for name, t in (("out", out), ("do", do)):
        if t.dtype != v.dtype or t.shape != v.shape or t.device != v.device:
            raise ValueError(f"{name} must match v in dtype, shape and device")
    if not do.is_contiguous():  # out is read only by bwd_delta, through its strides
        raise ValueError("do must be contiguous")
    B, P, h, f = v.shape
    if lse.dtype != torch.float32 or lse.shape != (h, B, P) or lse.device != v.device:
        raise ValueError("lse must be fp32 [h, B, P] on v's device")
    lse = lse.contiguous()
    delta = bwd_delta(do, out)
    e_dtypes = e_row.dtype, e_col.dtype
    e_row, e_col = e_row.float(), e_col.float()
    der, dec, dv = torch.empty_like(e_row), torch.empty_like(e_col), torch.empty_like(v)
    n_kb = -(-P // KERNEL_KEYS)
    part = (torch.empty((n_kb, B, P, h), dtype=torch.float32, device=v.device)
            if n_kb > 1 else None)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.dfgnn_flash_add_bwd(
            _DTYPE_CODES[v.dtype], e_row.data_ptr(), e_col.data_ptr(), v.data_ptr(),
            adj.data_ptr(), None if val is None else val.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), do.data_ptr(), der.data_ptr(),
            None if part is None else part.data_ptr(), dec.data_ptr(), dv.data_ptr(),
            B, P, h, f, slope, *_dropout_args(seed, rate), int(one),
            torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "flash_add_bwd")
    global ADD_BWD_LAUNCHES
    ADD_BWD_LAUNCHES += 1
    return der.to(e_dtypes[0]), dec.to(e_dtypes[1]), dv


class _FlashDot(torch.autograd.Function):
    """Kernels #1 and #3 in autograd, on every device.

    The forward saves q, k, v, out and lse; the backward runs
    :func:`flash_mask_bwd` (the plain versions on CPU tensors, the kernels
    on CUDA tensors).  ``seed``, ``rate`` and ``precision`` are constants;
    the backward regenerates the forward's dropout mask from the seed and
    runs at the forward's precision, as the JAX VJP passes ``prec``.  ``adj`` and
    ``val`` get no gradient: edge values are constants on this path, as in
    the JAX package's ``_flash_dot_bwd``.
    """

    @staticmethod
    def forward(ctx, q, k, v, adj, val, seed=0, rate=0.0, precision=None):
        need = any(ctx.needs_input_grad)
        out, lse = flash_mask_fwd(q, k, v, adj, val, seed=seed, rate=rate, want_lse=need,
                                  precision=precision)
        if need:
            ctx.save_for_backward(q, k, v, adj, val, out, lse)
            ctx.kw = dict(seed=seed, rate=rate, precision=precision)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, adj, val, out, lse = ctx.saved_tensors
        # grad_out may come expanded or strided (e.g. from .sum()); the kernel
        # reads [B, P, h, f] contiguous
        dq, dk, dv = flash_mask_bwd(q, k, v, adj, val, out, lse, grad_out.contiguous(),
                                    **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class _FlashAdd(torch.autograd.Function):
    """Kernels #2 and #4 in autograd, on every device.

    ``slope``, ``seed``, ``rate`` and ``precision`` are constants; the
    backward regenerates the forward's dropout mask from the seed and runs
    at the forward's precision.  ``adj`` and ``val`` get no gradient, as in
    the JAX package's ``_flash_add_bwd``.
    """

    @staticmethod
    def forward(ctx, e_row, e_col, v, adj, val, slope, seed, rate, precision=None):
        need = any(ctx.needs_input_grad)
        out, lse = flash_add_fwd(e_row, e_col, v, adj, val, slope=slope, seed=seed,
                                 rate=rate, want_lse=need, precision=precision)
        if need:
            ctx.save_for_backward(e_row, e_col, v, adj, val, out, lse)
            ctx.kw = dict(slope=slope, seed=seed, rate=rate, precision=precision)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        e_row, e_col, v, adj, val, out, lse = ctx.saved_tensors
        der, dec, dv = flash_add_bwd(e_row, e_col, v, adj, val, out, lse,
                                     grad_out.contiguous(), **ctx.kw)
        return der, dec, dv, None, None, None, None, None, None


def flash_graph_attention(
    batch: DenseBatch,
    q: Optional[torch.Tensor],
    k: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    score: str = "dot",
    e_row: Optional[torch.Tensor] = None,
    e_col: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Fused masked attention over a :class:`DenseBatch`, ``[B, P, h, f]``.

    Numerics match :func:`dfgnn_tpu_torch.ops.dense_block.dense_graph_attention`.
    ``score="add"`` takes node-major ``e_row``/``e_col`` ``[B, P, h]``.  On
    either score, ``dropout_rate > 0`` drops the attention weights in the
    kernels with the edge hash of a seed drawn from ``dropout_generator`` (a
    CPU generator).  ``precision`` (None, ``"highest"``, ``"default"``) is
    the JAX package's, resolved on v's dtype (:func:`resolve_precision`):
    ``"default"`` runs fp32 products as one TF32 pass, forward and backward.
    Edge values (``batch.val``) scale the raw scores and get no gradient.
    Differentiable through :class:`_FlashDot` and :class:`_FlashAdd`: the
    kernels on CUDA tensors, their plain versions on CPU tensors.
    """
    if score not in ("dot", "add"):
        raise ValueError(f"unknown score mode {score!r}")
    precision = resolve_precision(precision, v.dtype)
    rate = float(dropout_rate)
    val = None if batch.val is None else batch.val.float()
    seed = 0
    if rate > 0.0:
        if dropout_generator is None:
            raise ValueError("dropout_rate > 0 requires dropout_generator")
        seed = edge_dropout.seed_from_generator(dropout_generator)
    if score == "add":
        return _FlashAdd.apply(e_row.contiguous(), e_col.contiguous(), v, batch.adj, val,
                               float(negative_slope), seed, rate, precision)
    return _FlashDot.apply(q, k, v, batch.adj, val, seed, rate, precision)


# ---------------------------------------------------------------------------
# The whole-layer kernels (#5, #6): the projections and the attention of one
# conv layer in one launch.  Their backward recomputes q, k, v (or z, e_l,
# e_r) with torch ops and reuses kernels #1 and #3 (or #2 and #4), as the JAX
# package's custom VJPs reuse its Pallas kernels.
# ---------------------------------------------------------------------------

def layer_fits(score: str, P: int, f: int) -> bool:
    """Whether kernel #5 (``score="dot"``) or #6 (``"add"``) takes a layer of
    head dim ``f`` over ``P`` nodes.  Both stream their key tiles past
    P = 128 and take a wide head in column chunks (their blocks grow with
    neither; past P = 2048 they walk their keys in windows), so both take one
    set, in fp32 and bf16, as :func:`flash_takes` does: any f >= 1 and
    P >= 1, as JAX's Pallas route takes any."""
    if score not in ("dot", "add"):
        raise ValueError(f"unknown score mode {score!r}")
    return f >= 1 and P >= 1


def flash_takes(score: str, P: int, f: int) -> bool:
    """Whether the flash kernels of ``score`` (#1 and #3, or #2 and #4) take
    a DenseBatch of ``P`` nodes and head dim ``f``: the shape rule of
    ``method="auto"``.  Both scores take the same set: any f >= 1 (past 256
    in wide blocks, :func:`fwd_column_groups`) and P >= 1 (past 2048 in
    windows of 2048 keys or rows), so ``auto`` takes flash at every shape,
    as JAX takes Pallas."""
    return f >= 1 and P >= 1


WIDE_COLS = 512  # columns of out a wide forward block of #1 and #2 holds


def fwd_column_groups(f: int) -> tuple:
    """The column groups ``(first column, width)`` over which the forward
    kernels #1 and #2 split a head of dim ``f``: the whole head up to f =
    256, past it groups of WIDE_COLS columns (the last one partial), each
    group's blocks forming every score again and writing its columns of
    ``out``, group 0's blocks also ``lse`` (every group forms the same l,
    so its lse is theirs).  The C entry points keep the same rule."""
    if f < 1:
        raise ValueError(f"f must be >= 1, got {f}")
    width = f if f <= 256 else WIDE_COLS
    return tuple((c, min(width, f - c)) for c in range(0, f, width))


def _layer_project(x, w, b, scale: float = 1.0, tf32: bool = False):
    """``(x . W + b) * scale`` ``[B, P, h, f]`` fp32 from ``x`` ``[B, P, din]``,
    ``w`` ``[h, din, f]`` and fp32 ``b`` ``[h, f]``: the products of the
    input-dtype values (rounded to TF32 with ``tf32``) summed in fp32, as
    the kernels and the JAX VJPs form them."""
    return (torch.einsum("bpd,hdf->bphf", _mm(x, tf32).float(), _mm(w, tf32).float())
            + b) * scale


def _layer_qkv(x, wq, bq, wk, bk, wv, bv, scale: float, tf32: bool = False):
    """q, k, v ``[B, P, h, f]``: the fp32 projections (q times ``scale``)
    rounded to x's dtype, as kernel #5 forms them."""
    return [_layer_project(x, w, b, s, tf32).to(x.dtype)
            for w, b, s in ((wq, bq, scale), (wk, bk, 1.0), (wv, bv, 1.0))]


def flash_layer_dot_fwd_plain(x, wq, bq, wk, bk, wv, bv, adj, *, scale: float,
                              precision: Optional[str] = None):
    """Kernel #5's function in plain PyTorch, on any device.

    ``x``: ``[B, P, din]``; ``w*``: ``[h, din, f]`` of x's dtype; ``b*``: fp32
    ``[h, f]``; ``adj``: ``[B, P, P]``.  q, k and v are the fp32 projections
    (q times ``scale``) rounded to x's dtype, then kernel #1's function.
    ``precision="default"`` rounds the operands of every product, the
    projections' too, to TF32.  Returns ``out`` ``[B, P, h, f]`` in x's
    dtype.
    """
    tf32 = _one_pass(precision, x.dtype)
    q, k, v = _layer_qkv(x, wq, bq, wk, bk, wv, bv, scale, tf32)
    return flash_mask_fwd_plain(q, k, v, adj, precision=precision)[0]


def _layer_add_scalars(z32, al, ar):
    """``e_l, e_r`` ``[B, P, h]`` fp32: the fp32 ``z`` contracted with ``a_l``
    and ``a_r`` ``[h, f]``."""
    return (z32 * al).sum(dim=-1), (z32 * ar).sum(dim=-1)


def flash_layer_add_fwd_plain(x, w, b, al, ar, adj, *, slope: float = 0.2, seed: int = 0,
                              rate: float = 0.0, precision: Optional[str] = None):
    """Kernel #6's function in plain PyTorch, on any device.

    ``x``: ``[B, P, din]``; ``w``: ``[h, din, f]`` of x's dtype; ``b``, ``al``,
    ``ar``: fp32 ``[h, f]``.  ``z = x . W + b`` in fp32; ``e_l``, ``e_r`` come
    from that fp32 ``z``, and ``z`` rounded to x's dtype enters kernel #2's
    function with the edge-hash dropout of ``seed`` and ``rate``.
    ``precision="default"`` rounds the operands of x . W and ex . z to TF32
    (the contractions with a_l and a_r stay fp32, as in the kernel).
    Returns ``out`` ``[B, P, h, f]`` in x's dtype.
    """
    z32 = _layer_project(x, w, b, tf32=_one_pass(precision, x.dtype))
    el, er = _layer_add_scalars(z32, al, ar)
    return flash_add_fwd_plain(el, er, z32.to(x.dtype), adj, slope=slope, seed=seed,
                               rate=rate, precision=precision)[0]


def _check_layer_args(score, x, adj, ws, fp32s):
    """What kernels #5 and #6 take: fp32 or bf16 ``x`` ``[B, P, din]``,
    weights ``ws`` ``[h, din, f]`` of x's dtype, fp32 ``[h, f]`` vectors
    ``fp32s``, uint8 ``adj`` ``[B, P, P]``, all contiguous on x's device, at
    a shape :func:`layer_fits` takes."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes fp32 or bf16, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, P, din], got {tuple(x.shape)}")
    B, P, din = x.shape
    h, _, f = ws[0].shape
    for t in ws:
        if t.dtype != x.dtype or t.shape != (h, din, f) or t.device != x.device:
            raise ValueError("the weights must be [h, din, f] of x's dtype on x's device")
    for t in fp32s:
        if t.dtype != torch.float32 or t.shape != (h, f) or t.device != x.device:
            raise ValueError("biases and score vectors must be fp32 [h, f] on x's device")
    if adj.dtype != torch.uint8 or adj.shape != (B, P, P) or adj.device != x.device:
        raise ValueError("adj must be uint8 [B, P, P] on x's device")
    if not all(t.is_contiguous() for t in (x, adj, *ws, *fp32s)):
        raise ValueError("the kernel takes contiguous tensors")
    if layer_fits(score, P, f) and B >= 1 and h >= 1 and din >= 1:
        return
    kernel = "#5 (_layer_kernel_dot)" if score == "dot" else "#6 (_layer_kernel_add)"
    raise ValueError(f"kernel {kernel} takes B, P, h, din, f >= 1, got B={B} P={P} h={h} "
                     f"din={din} f={f}")


def layer_dot_scratch_shape(B: int, P: int, h: int, f: int) -> Optional[tuple]:
    """The shape of kernel #5's scratch, or None where it takes none.

    Past f = 256 and P = 128 the kernel projects q, k and v of every live
    node once into a scratch of x's dtype, ``[3, B, Pp, h, Fp]`` with
    ``Pp = P`` rounded up to 16 and ``Fp = f`` rounded up to 128 (the C
    entry point lays it out the same and refuses fewer elements), then
    attends from it; every other shape projects inside its one block.
    """
    if f <= 256 or P <= 128:
        return None
    return (3, B, -(-P // 16) * 16, h, -(-f // 128) * 128)


def flash_layer_dot_fwd(x, wq, bq, wk, bk, wv, bv, adj, *, scale: float,
                        precision: Optional[str] = None):
    """The whole GT layer forward: ``out`` ``[B, P, h, f]`` in x's dtype.

    CPU tensors run :func:`flash_layer_dot_fwd_plain`.  CUDA tensors launch
    kernel #5 on the current stream: fp32 or bf16 ``x`` ``[B, P, din]``,
    ``w*`` ``[h, din, f]`` of x's dtype, fp32 ``b*`` ``[h, f]``, uint8
    ``adj``, all contiguous, any P, f >= 1 (:func:`layer_fits`);
    ``precision`` as :func:`flash_mask_fwd`'s.  Anything else raises.
    Past f = 256 the head goes in column chunks: at P <= 128 one block per
    (graph, head) projects each node once and forms the scores once; past
    it the C entry point launches twice, a projection of every live node
    into a scratch of :func:`layer_dot_scratch_shape` (allocated here), then
    an attention that forms the scores once per 64 query rows, key tile and
    512 columns of ``out``: one #5 launch in the count.
    """
    if x.device.type == "cpu":
        return flash_layer_dot_fwd_plain(x, wq, bq, wk, bk, wv, bv, adj, scale=scale,
                                         precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"no flash_layer_dot_fwd kernel for device {x.device}")
    _check_layer_args("dot", x, adj, (wq, wk, wv), (bq, bk, bv))
    one = _one_pass(precision, x.dtype)
    B, P, din = x.shape
    h, _, f = wq.shape
    out = torch.empty((B, P, h, f), dtype=x.dtype, device=x.device)
    shape = layer_dot_scratch_shape(B, P, h, f)
    scratch = None if shape is None else torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dfgnn_flash_layer_dot_fwd(
            _DTYPE_CODES[x.dtype], x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wk.data_ptr(),
            bk.data_ptr(), wv.data_ptr(), bv.data_ptr(), adj.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), B, P, h, din, f, float(scale), int(one),
            torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "flash_layer_dot_fwd")
    global LAYER_LAUNCHES
    LAYER_LAUNCHES += 1
    return out


def flash_layer_add_fwd(x, w, b, al, ar, adj, *, slope: float = 0.2, seed: int = 0,
                        rate: float = 0.0, precision: Optional[str] = None):
    """The whole GAT layer forward: ``out`` ``[B, P, h, f]`` in x's dtype.

    CPU tensors run :func:`flash_layer_add_fwd_plain`.  CUDA tensors launch
    kernel #6 on the current stream: fp32 or bf16 ``x`` ``[B, P, din]``,
    ``w`` ``[h, din, f]`` of x's dtype, fp32 ``b``, ``al``, ``ar`` ``[h, f]``,
    uint8 ``adj``, all contiguous, any P, f >= 1 (:func:`layer_fits`);
    ``0 <= rate < 1`` and a uint32 ``seed``; ``precision`` as
    :func:`flash_mask_fwd`'s.  Anything else raises.  The
    wrapper always passes a ``[2, B, P, h]`` fp32 scratch tensor: past f =
    256 the C entry point launches twice (the score scalars into it, then
    the attention), one #6 launch in the count.
    """
    if x.device.type == "cpu":
        return flash_layer_add_fwd_plain(x, w, b, al, ar, adj, slope=slope, seed=seed,
                                         rate=rate, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"no flash_layer_add_fwd kernel for device {x.device}")
    _check_layer_args("add", x, adj, (w,), (b, al, ar))
    _check_dropout(seed, rate)
    one = _one_pass(precision, x.dtype)
    B, P, din = x.shape
    h, _, f = w.shape
    out = torch.empty((B, P, h, f), dtype=x.dtype, device=x.device)
    scalars = torch.empty((2, B, P, h), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dfgnn_flash_layer_add_fwd(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(), al.data_ptr(),
            ar.data_ptr(), adj.data_ptr(), out.data_ptr(), scalars.data_ptr(), B, P, h, din,
            f, float(slope), *_dropout_args(seed, rate), int(one),
            torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "flash_layer_add_fwd")
    global LAYER_ADD_LAUNCHES
    LAYER_ADD_LAUNCHES += 1
    return out


def _projection_grads(x32, w32, dy):
    """``(dW [h, din, f], db [h, f], dx [B, P, din])`` of ``y = x . W + b``
    from ``dy`` ``[B, P, h, f]``, all fp32."""
    return (torch.einsum("bpd,bphf->hdf", x32, dy), dy.sum(dim=(0, 1)),
            torch.einsum("bphf,hdf->bpd", dy, w32))


class _FlashLayerDot(torch.autograd.Function):
    """Kernel #5 in autograd, on every device: the JAX package's
    ``_flash_layer_dot`` and its VJP.

    The forward casts the fp32 weights ``[h, din, f]`` to x's dtype and
    launches #5.  The backward recomputes q, k and v with the forward's
    rounding (TF32 operands at ``precision="default"``), takes lse from
    kernel #1 and dq, dk, dv from kernel #3 (the saved output for
    ``delta``) at the forward's precision, and contracts them to dx, dW and
    db in fp32 (by design at either precision).  ``adj`` gets no gradient.
    """

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, adj, scale, precision=None):
        ws = [w.to(x.dtype).contiguous() for w in (wq, wk, wv)]
        out = flash_layer_dot_fwd(x, ws[0], bq, ws[1], bk, ws[2], bv, adj, scale=scale,
                                  precision=precision)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, *ws, bq, bk, bv, adj, out)
            ctx.scale, ctx.precision = scale, precision
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, wq, wk, wv, bq, bk, bv, adj, out = ctx.saved_tensors
        scale, prec = ctx.scale, ctx.precision
        q, k, v = _layer_qkv(x, wq, bq, wk, bk, wv, bv, scale, _one_pass(prec, x.dtype))
        _, lse = flash_mask_fwd(q, k, v, adj, None, want_lse=True, precision=prec)
        dq, dk, dv = flash_mask_bwd(q, k, v, adj, None, out, lse, grad_out.contiguous(),
                                    precision=prec)
        x32 = x.float()
        grads, dx = [], torch.zeros_like(x32)
        for w, dy in ((wq, dq.float() * scale), (wk, dk.float()), (wv, dv.float())):
            dw, db, dx_part = _projection_grads(x32, w.float(), dy)
            grads += [dw, db]
            dx = dx + dx_part
        dwq, dbq, dwk, dbk, dwv, dbv = grads
        return dx.to(x.dtype), dwq, dbq, dwk, dbk, dwv, dbv, None, None, None


class _FlashLayerAdd(torch.autograd.Function):
    """Kernel #6 in autograd, on every device: the JAX package's
    ``_flash_layer_add`` and its VJP.

    The forward casts the fp32 weight ``[h, din, f]`` to x's dtype and
    launches #6.  The backward recomputes z32 (TF32 operands at
    ``precision="default"``), e_l and e_r, takes lse from kernel #2 and
    (d e_l, d e_r, dz) from kernel #4 with the forward's seed, rate and
    precision, forms dz + d e_l a_l + d e_r a_r, and contracts to dx, dW,
    db, da_l and da_r in fp32 (by design at either precision).  ``adj`` gets
    no gradient.
    """

    @staticmethod
    def forward(ctx, x, w, b, al, ar, adj, slope, seed, rate, precision=None):
        wt = w.to(x.dtype).contiguous()
        out = flash_layer_add_fwd(x, wt, b, al, ar, adj, slope=slope, seed=seed, rate=rate,
                                  precision=precision)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, wt, b, al, ar, adj, out)
            ctx.kw = dict(slope=slope, seed=seed, rate=rate, precision=precision)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, wt, b, al, ar, adj, out = ctx.saved_tensors
        z32 = _layer_project(x, wt, b, tf32=_one_pass(ctx.kw["precision"], x.dtype))
        z = z32.to(x.dtype)
        el, er = _layer_add_scalars(z32, al, ar)
        _, lse = flash_add_fwd(el, er, z, adj, None, want_lse=True, **ctx.kw)
        der, dec, dz_attn = flash_add_bwd(el, er, z, adj, None, out, lse,
                                          grad_out.contiguous(), **ctx.kw)
        dz = dz_attn.float() + der[..., None] * al + dec[..., None] * ar
        dal = torch.einsum("bph,bphf->hf", der, z32)
        dar = torch.einsum("bph,bphf->hf", dec, z32)
        dw, db, dx = _projection_grads(x.float(), wt.float(), dz)
        return dx.to(x.dtype), dw, db, dal, dar, None, None, None, None, None


def _layer_batch(batch) -> None:
    """What the whole-layer path takes: a DenseBatch without edge values."""
    if not isinstance(batch, DenseBatch):
        raise ValueError(f"impl='flash_fused' runs on a DenseBatch, not {type(batch).__name__}")
    if batch.val is not None:
        raise NotImplementedError("fused layer path does not take edge values")


def _heads_first(w, din: int, h: int, f: int):
    """A Dense kernel ``[din, h*f]`` as the kernels' ``[h, din, f]``."""
    return w.reshape(din, h, f).permute(1, 0, 2)


def flash_layer_attention(
    batch: DenseBatch,
    x: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    *,
    num_heads: int,
    scale: float,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """The whole GT conv layer (q, k, v projections and masked attention) as
    kernel #5 over a :class:`DenseBatch`.

    ``x``: node-flat ``[B*P, din]``; ``w*``: Dense kernels ``[din, h*f]``
    (fp32 parameters, cast to x's dtype); ``b*``: biases ``[h*f]``.
    ``precision`` as :func:`flash_graph_attention`'s, resolved on x's dtype.
    Returns node-flat ``[B*P, h*f]`` in x's dtype.  Differentiable through
    :class:`_FlashLayerDot`; raises on edge values (``batch.val``).
    """
    _layer_batch(batch)
    precision = resolve_precision(precision, x.dtype)
    B, P = batch.n_graphs, batch.np_pad
    din, h = x.shape[-1], num_heads
    f = wq.shape[-1] // h
    w = lambda t: _heads_first(t, din, h, f)
    bias = lambda t: t.reshape(h, f).float()
    out = _FlashLayerDot.apply(x.reshape(B, P, din).contiguous(), w(wq), bias(bq), w(wk),
                               bias(bk), w(wv), bias(bv), batch.adj, float(scale), precision)
    return out.reshape(B * P, h * f)


def flash_layer_attention_gat(
    batch: DenseBatch,
    x: torch.Tensor,
    w: torch.Tensor, b: torch.Tensor,
    a_l: torch.Tensor, a_r: torch.Tensor,
    *,
    num_heads: int,
    negative_slope: float = 0.2,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """The whole GAT conv layer (W projection, a_l / a_r scoring, masked
    additive attention, optional in-kernel dropout) as kernel #6 over a
    :class:`DenseBatch`.

    ``x``: node-flat ``[B*P, din]``; ``w``: Dense kernel ``[din, h*f]``;
    ``b``: bias ``[h*f]``; ``a_l``, ``a_r``: ``[f, h]`` (the layer's
    convention).  ``dropout_rate > 0`` drops attention weights with the edge
    hash of a seed drawn from ``dropout_generator`` (a CPU generator).
    ``precision`` as :func:`flash_graph_attention`'s, resolved on x's dtype.
    Returns node-flat ``[B*P, h*f]`` in x's dtype.  Differentiable through
    :class:`_FlashLayerAdd`; raises on edge values (``batch.val``).
    """
    _layer_batch(batch)
    precision = resolve_precision(precision, x.dtype)
    rate = float(dropout_rate)
    seed = 0
    if rate > 0.0:
        if dropout_generator is None:
            raise ValueError("dropout_rate > 0 requires dropout_generator")
        seed = edge_dropout.seed_from_generator(dropout_generator)
    B, P = batch.n_graphs, batch.np_pad
    din, h = x.shape[-1], num_heads
    f = w.shape[-1] // h
    out = _FlashLayerAdd.apply(x.reshape(B, P, din).contiguous(), _heads_first(w, din, h, f),
                               b.reshape(h, f).float(), a_l.T.float().contiguous(),
                               a_r.T.float().contiguous(), batch.adj, float(negative_slope),
                               seed, rate, precision)
    return out.reshape(B * P, h * f)
