"""The gather kernels' plain versions against what the Pallas probe kernels
compute (CPU).

``_dma_kernel`` (#7) and ``_take_kernel`` (#8) of the JAX gather probe use
TPU DMA semaphores and memory spaces and do not run in interpret mode here,
so the plain versions are held against ``jnp.take`` and
``jnp.take_along_axis(mode="clip")``, the functions those kernels compute.
The CUDA kernels are held against the plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu_torch.ops import gather
from dfgnn_tpu_torch.scripts import microbench_gather


@pytest.mark.parametrize("N,shape,dtype,M", [
    (4096, (128,), np.float32, 10000),
    (1000, (2, 64), np.float32, 777),
    (300, (64,), "bfloat16", 5),
])
def test_gather_rows_plain_is_jnp_take(N, shape, dtype, M):
    rng = np.random.default_rng(N)
    tbl = rng.standard_normal((N, *shape)).astype(np.float32)
    idx = rng.integers(0, N, M).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(tbl, dtype=dtype), jnp.asarray(idx), axis=0))
    t = torch.from_numpy(tbl)
    if dtype == "bfloat16":
        t = t.bfloat16()
    gather.reset_launch_counts()
    got = gather.gather_rows(t, torch.from_numpy(idx))  # CPU tensors: the plain version
    assert gather.launch_counts() == (0, 0)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    with pytest.raises(IndexError):  # out of [0, N): the kernel's contract, checked here
        gather.gather_rows_plain(t, torch.tensor([N], dtype=torch.int32))


@pytest.mark.parametrize("S", [512, 1024, 4096, 20000])
def test_take_rows_plain_is_take_along_axis_clip(S):
    rng = np.random.default_rng(S)
    slab = rng.standard_normal((S, 128)).astype(np.float32)
    idx = rng.integers(-100, S + 100, 4096).astype(np.int32)
    idx2 = np.broadcast_to(idx[:, None], (idx.size, 128))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(slab), jnp.asarray(idx2), axis=0,
                                          mode="clip"))
    got = gather.take_rows(torch.from_numpy(slab), torch.from_numpy(idx))
    assert gather.launch_counts() == (0, 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_rows_supported_set():
    """Kernel #8 reads whole rows of the slab where it lies: every slab size an
    int32 id reaches has a plan (a warp instruction's rows and lanes), the
    slabs past the old shared-memory kernel's ~14,000 rows of 512 B too; no
    plan past int32 ids or for rows that are not whole 16-byte pieces."""
    for S in (512, 1024, 4096, 20000, 10 ** 6, gather.TAKE_MAX_ROWS):
        assert gather.take_plan(S, 512) == (32, 1)  # one 512 B row a warp instruction
    assert gather.take_plan(3000, 48) == (4, 8)     # 3 pieces: 8 rows of 4 lanes
    assert gather.take_plan(7, 256) == (16, 2)
    assert gather.take_plan(64, 16) == (1, 32)
    assert gather.take_plan(64, 1024) == (32, 1)    # 64 pieces, walked 32 at a time
    assert gather.take_plan(gather.TAKE_MAX_ROWS + 1, 512) is None
    assert gather.take_plan(0, 512) is None
    assert gather.take_plan(64, 24) is None
    assert gather.take_plan(64, 8) is None


def test_wrappers_refuse_other_devices_and_the_probe_needs_a_card(monkeypatch):
    meta = torch.empty((8, 4), device="meta")
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no gather_rows kernel"):
        gather.gather_rows(meta, ids)
    with pytest.raises(ValueError, match="no take_rows kernel"):
        gather.take_rows(meta, ids)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench_gather.main(["--rows", "16", "--table", "16", "--no-sweep"])
