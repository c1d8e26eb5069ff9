"""Masked dense flash attention over a :class:`DenseBatch`, forward kernel.

The counterpart of :mod:`dfgnn_tpu.ops.pallas.flash_mask` for the dot
score.  The Pallas kernel ``_fwd_kernel_dot`` becomes the hand-written CUDA
kernel in ``csrc/flash_mask_fwd.cu``, built with ``nvcc`` for ``sm_90a`` at
first use and bound with ``ctypes``.

:func:`flash_mask_fwd` is the kernel's wrapper.  For tensors on the CPU it
runs :func:`flash_mask_fwd_plain`, the same function in plain PyTorch; for
CUDA tensors it launches the kernel or raises.  It never falls back.
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

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_mask_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# What the kernel takes (see csrc/flash_mask_fwd.cu): head dims it is
# instantiated for, and the most nodes whose score rows fit shared memory.
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
KERNEL_MAX_P = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0  # kernel launches by flash_mask_fwd; callers may reset it to 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile the kernel into ``_build/`` unless this source is built.

    The library's name carries a hash of the source and flags, so a stale
    build is never loaded; it is written under a temporary name and renamed,
    so a concurrent process never loads a half-written file.  Returns the
    library's path and the compiler's messages ('' when already built).
    """
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_mask_fwd-{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dfgnn_flash_mask_fwd.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.dfgnn_flash_mask_fwd.restype = i
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


class _FlashDot(torch.autograd.Function):
    """Kernel forward; the backward kernel is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, adj, val):
        return flash_mask_fwd(q, k, v, adj, val)[0]

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the flash attention backward (_bwd_kernel_dot) has no CUDA kernel "
            "yet; it is ROADMAP.md queue 2, kernel #3. Train with method='dense' "
            "until then.")


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
    Edge values (``batch.val``) scale the raw scores.  On CPU tensors the
    plain version runs and autograd differentiates it; on CUDA tensors the
    kernel runs and has no backward yet.
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
    if q.device.type == "cpu":
        return flash_mask_fwd_plain(q, k, v, batch.adj, val)[0]
    return _FlashDot.apply(q, k, v, batch.adj, val)
