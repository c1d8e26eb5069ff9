"""Masked dense flash attention over a :class:`DenseBatch`, forward and backward.

The counterpart of :mod:`dfgnn_tpu.ops.pallas.flash_mask` for the dot
score.  The Pallas kernels ``_fwd_kernel_dot`` and ``_bwd_kernel_dot``
become the hand-written CUDA kernels in ``csrc/flash_mask_fwd.cu`` and
``csrc/flash_mask_bwd.cu``, built with ``nvcc`` for ``sm_90a`` into one
library at first use and bound with ``ctypes``.

:func:`flash_mask_fwd` and :func:`flash_mask_bwd` are the kernels' wrappers.
For tensors on the CPU they run :func:`flash_mask_fwd_plain` and
:func:`flash_mask_bwd_plain`, the same functions in plain PyTorch; for CUDA
tensors they launch the kernels or raise.  They never fall back.
:class:`_FlashDot` ties the two into autograd on every device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops.dense_block import NEG_BIG

DEAD = 0.5 * NEG_BIG  # row-max clamp: exp(s - m) underflows to 0 on masked lanes

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# What the kernel takes (see csrc/flash_mask_fwd.cu): head dims it is
# instantiated for, and the most nodes whose score rows fit shared memory.
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
KERNEL_MAX_P = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0  # forward kernel launches by flash_mask_fwd; callers may reset it to 0
BWD_LAUNCHES = 0  # backward launches by flash_mask_bwd (one per call); resettable


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile every ``csrc/*.cu`` into one library in ``_build/``, unless built.

    The library's name carries a hash of all sources, headers and flags, so
    a stale build is never loaded.  The sources compile in parallel, one
    ``nvcc`` each; the library is linked under a temporary name and renamed,
    so a concurrent process never loads a half-written file.  Returns the
    library's path and the compiler's messages ('' when already built).
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    lib = BUILD_DIR / f"libdfgnn_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.so"
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib, "".join(logs)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dfgnn_flash_mask_fwd.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.dfgnn_flash_mask_fwd.restype = i
    lib.dfgnn_flash_mask_bwd.argtypes = [i, *[vp] * 11, i, i, i, i, vp]
    lib.dfgnn_flash_mask_bwd.restype = i
    lib.dfgnn_cuda_error_string.argtypes = [i]
    lib.dfgnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_mask_fwd_plain(q, k, v, adj, val=None):
    """The kernel's function in plain PyTorch, on any device.

    ``q, k, v``: ``[B, P, h, f]`` (q pre-scaled); ``adj``: ``[B, P, P]``;
    ``val``: ``[B, P, P]`` or None.  Returns ``out`` ``[B, P, h, f]`` in v's
    dtype and ``lse`` ``[h, B, P]`` fp32.  Scores and sums are fp32; ``ex``
    is rounded to v's dtype before the product, as in the Pallas kernel.
    """
    s = torch.einsum("brhf,bchf->bhrc", q.float(), k.float())
    if val is not None:
        s = s * val[:, None].float()
    s = torch.where(adj[:, None].bool(), s, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEAD)
    ex = torch.exp(s - m)
    l = ex.sum(dim=-1, keepdim=True)
    has = l > 0
    inv = torch.where(has, 1.0 / torch.where(has, l, 1.0), 0.0)
    out = torch.einsum("bhrc,bchf->brhf", ex.to(v.dtype).float(), v.float())
    out = (out * inv.transpose(1, 2)).to(v.dtype)
    lse = torch.where(has, m + torch.log(torch.where(has, l, 1.0)), NEG_BIG)
    return out, lse[..., 0].permute(1, 0, 2)


def bwd_delta(do, out):
    """``delta = rowsum(dO * out)`` ``[h, B, P]`` fp32: the backward's input
    that stays outside its kernel, as in the JAX package's ``_bwd``."""
    return torch.einsum("bphf,bphf->hbp", do.float(), out.float()).contiguous()


def flash_mask_bwd_plain(q, k, v, adj, val, lse, do, delta):
    """The backward kernel's function in plain PyTorch, on any device.

    ``q, k, v, do``: ``[B, P, h, f]``; ``adj``, ``val``: as the forward's;
    ``lse``, ``delta``: ``[h, B, P]`` fp32.  Returns ``(dq, dk, dv)`` in the
    dtypes of q, k and v.  Scores, ``p`` and ``ds`` are fp32; ``ds`` and
    ``p`` are rounded to the input dtype before the products, as in the
    Pallas kernel.  Empty rows (lse = -1e30, no edges) give p = 0.
    """
    s = torch.einsum("brhf,bchf->bhrc", q.float(), k.float())
    if val is not None:
        s = s * val[:, None].float()
    edge = adj[:, None].bool()
    lse_b = lse.permute(1, 0, 2)[..., None]      # [B, h, P, 1]
    delta_b = delta.permute(1, 0, 2)[..., None]
    p = torch.where(edge, torch.exp(torch.where(edge, s - lse_b, 0.0)), 0.0)
    dp = torch.einsum("brhf,bchf->bhrc", do.float(), v.float())
    ds = p * (dp - delta_b)
    if val is not None:
        ds = ds * val[:, None].float()
    dq = torch.einsum("bhrc,bchf->brhf", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhrc,brhf->bchf", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhrc,brhf->bchf", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(q, k, v, adj, val):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes fp32 or bf16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must match q in dtype, shape and device")
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be [B, P, h, f], got {tuple(q.shape)}")
    B, P, h, f = q.shape
    if f not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {KERNEL_HEAD_DIMS}, not {f}")
    if not 1 <= P <= KERNEL_MAX_P or B < 1 or h < 1:
        raise ValueError(f"the kernel takes 1 <= P <= {KERNEL_MAX_P} and B, h >= 1, "
                         f"got B={B} P={P} h={h}")
    if adj.dtype != torch.uint8 or adj.shape != (B, P, P) or adj.device != q.device:
        raise ValueError("adj must be uint8 [B, P, P] on q's device")
    if val is not None and (val.dtype != torch.float32 or val.shape != (B, P, P)
                            or val.device != q.device):
        raise ValueError("val must be fp32 [B, P, P] on q's device")
    for name, t in (("q", q), ("k", k), ("v", v), ("adj", adj), ("val", val)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_mask_fwd(q, k, v, adj, val=None, *, want_lse: bool = False):
    """Masked attention forward: ``(out [B, P, h, f], lse [h, B, P] | None)``.

    CPU tensors run :func:`flash_mask_fwd_plain`.  CUDA tensors launch the
    kernel on the current stream: fp32 or bf16 ``q, k, v`` of one shape,
    contiguous; uint8 ``adj``; fp32 ``val`` or None.  Anything else raises.
    """
    if q.device.type == "cpu":
        out, lse = flash_mask_fwd_plain(q, k, v, adj, val)
        return out, (lse if want_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_mask_fwd kernel for device {q.device}")
    _check_kernel_args(q, k, v, adj, val)
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
            B, P, h, f, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("flash_mask_fwd kernel launch failed: "
                           + lib.dfgnn_cuda_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def flash_mask_bwd(q, k, v, adj, val, out, lse, do):
    """Masked attention backward: ``(dq, dk, dv)`` ``[B, P, h, f]``.

    ``out`` and ``lse`` are the forward's; ``do`` is the output's gradient.
    Computes ``delta`` (:func:`bwd_delta`), then on CPU tensors runs
    :func:`flash_mask_bwd_plain` and on CUDA tensors launches the kernel
    (two passes, one C call) on the current stream.  The kernel takes what
    the forward kernel takes, with ``out`` and ``do`` of q's dtype and shape,
    ``do`` contiguous, and ``lse`` fp32 ``[h, B, P]``; anything else raises.
    """
    if q.device.type == "cpu":
        return flash_mask_bwd_plain(q, k, v, adj, val, lse, do, bwd_delta(do, out))
    if q.device.type != "cuda":
        raise ValueError(f"no flash_mask_bwd kernel for device {q.device}")
    _check_kernel_args(q, k, v, adj, val)
    for name, t in (("out", out), ("do", do)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must match q in dtype, shape and device")
    if not do.is_contiguous():  # out is read only by bwd_delta, through its strides
        raise ValueError("do must be contiguous")
    B, P, h, f = q.shape
    if lse.dtype != torch.float32 or lse.shape != (h, B, P) or lse.device != q.device:
        raise ValueError("lse must be fp32 [h, B, P] on q's device")
    lse = lse.contiguous()  # a row per (head, graph, node): a cheap copy when strided
    delta = bwd_delta(do, out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.dfgnn_flash_mask_bwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            adj.data_ptr(), None if val is None else val.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, P, h, f, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("flash_mask_bwd kernel launch failed: "
                           + lib.dfgnn_cuda_error_string(err).decode())
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _FlashDot(torch.autograd.Function):
    """The flash kernels in autograd, on every device.

    The forward saves q, k, v, out and lse; the backward runs
    :func:`flash_mask_bwd` (the plain versions on CPU tensors, the kernels
    on CUDA tensors).  ``adj`` and ``val`` get no gradient: edge values are
    constants on this path, as in the JAX package's ``_flash_dot_bwd``.
    """

    @staticmethod
    def forward(ctx, q, k, v, adj, val):
        need = any(ctx.needs_input_grad)
        out, lse = flash_mask_fwd(q, k, v, adj, val, want_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, adj, val, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, adj, val, out, lse = ctx.saved_tensors
        # grad_out may come expanded or strided (e.g. from .sum()); the kernel
        # reads [B, P, h, f] contiguous
        dq, dk, dv = flash_mask_bwd(q, k, v, adj, val, out, lse, grad_out.contiguous())
        return dq, dk, dv, None, None


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
) -> torch.Tensor:
    """Fused masked attention over a :class:`DenseBatch`, ``[B, P, h, f]``.

    Numerics match :func:`dfgnn_tpu_torch.ops.dense_block.dense_graph_attention`.
    Edge values (``batch.val``) scale the raw scores and get no gradient.
    Differentiable through :class:`_FlashDot`: the kernels on CUDA tensors,
    their plain versions on CPU tensors.
    """
    del e_row, e_col, negative_slope, dropout_generator  # add score / dropout: not ported
    if score == "add":
        raise NotImplementedError(
            "the additive (GAT) flash kernel _fwd_kernel_add is not ported yet: "
            "ROADMAP.md queue 2, kernel #2")
    if score != "dot":
        raise ValueError(f"unknown score mode {score!r}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout (the edge hash) is not ported yet: "
            "ROADMAP.md queue 1 item 4. method='dense' takes dropout")
    val = None if batch.val is None else batch.val.float()
    return _FlashDot.apply(q, k, v, batch.adj, val)
