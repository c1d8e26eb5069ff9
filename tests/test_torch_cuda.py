"""The port's CUDA kernel against its plain PyTorch version, on the card.

Needs a CUDA device and skips without one.  Imports torch and numpy only, so
it also runs where JAX is missing:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from dfgnn_tpu_torch import DenseBatch, GTModel
from dfgnn_tpu_torch.data.synthetic import attention_inputs, pattern_like_batch
from dfgnn_tpu_torch.ops import flash_mask

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, h, P, f, *, with_val=False, dtype=torch.float32):
    """Seeded q, k, v, uint8 adj with padded nodes and empty rows, val."""
    q, k, v, adj, val = (torch.from_numpy(a).cuda()
                         for a in attention_inputs(np.random.default_rng(seed), B, h, P, f))
    return q.to(dtype), k.to(dtype), v.to(dtype), adj, val if with_val else None


@pytest.mark.parametrize("B,h,P,f,with_val", [
    (1024, 1, 128, 128, False),  # the serving path's shape
    (3, 2, 64, 16, True),
    (2, 4, 512, 32, False),
    (2, 2, 100, 64, True),       # P not a multiple of the tiles
    (3, 2, 40, 8, False),
    (1, 1, 2048, 256, False),    # the largest shape the kernel takes
])
def test_kernel_matches_plain_fp32(cuda, B, h, P, f, with_val):
    q, k, v, adj, val = _inputs(0, B, h, P, f, with_val=with_val)
    out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, val, want_lse=True)
    torch.cuda.synchronize()
    want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    assert (lse == flash_mask.NEG_BIG).any()  # empty rows were covered


def test_kernel_matches_plain_bf16(cuda):
    q, k, v, adj, _ = _inputs(1, 64, 2, 128, 64, dtype=torch.bfloat16)
    out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, want_lse=True)
    want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj)
    assert out.dtype == torch.bfloat16
    # outputs are O(1) values rounded to bf16 (8 significant bits)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0, atol=3e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)


def test_launch_counter_counts_kernel_launches_only(cuda):
    q, k, v, adj, _ = _inputs(2, 2, 1, 64, 32)
    flash_mask.LAUNCHES = 0
    flash_mask.flash_mask_fwd(q, k, v, adj)
    flash_mask.flash_mask_fwd(q.cpu(), k.cpu(), v.cpu(), adj.cpu())
    flash_mask.flash_mask_fwd_plain(q, k, v, adj)
    assert flash_mask.LAUNCHES == 1


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, adj, _ = _inputs(3, 2, 2, 64, 32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_mask.flash_mask_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, adj)
    with pytest.raises(TypeError):
        flash_mask.flash_mask_fwd(q.double(), k.double(), v.double(), adj)
    with pytest.raises(ValueError, match="uint8"):
        flash_mask.flash_mask_fwd(q, k, v, adj.bool())
    q48 = torch.zeros(2, 64, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_mask.flash_mask_fwd(q48, q48, q48, adj)


def test_flash_backward_raises(cuda):
    q, k, v, adj, _ = _inputs(4, 2, 1, 64, 32)
    q.requires_grad_(True)
    batch = DenseBatch(adj=adj, node_mask=torch.ones(2, 64, dtype=torch.bool, device=cuda),
                       n_graphs=2, np_pad=64)
    out = flash_mask.flash_graph_attention(batch, q, k, v)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


def test_gtmodel_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 4)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128)
    x = torch.from_numpy(rng.integers(0, 3, size=(batch.n_graphs * batch.np_pad,)))
    model = GTModel("PATTERN", out_size=2, hidden_size=128, num_layers=8,
                    generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = model(batch, x)
        flash_mask.LAUNCHES = 0
        got = model.to(cuda)(batch.to(cuda), x.to(cuda))
    assert flash_mask.LAUNCHES == 8
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)
