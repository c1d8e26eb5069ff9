"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and skips without one.  Imports torch and numpy only, so
it also runs where JAX is missing:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from dfgnn_tpu_torch import DenseBatch, GTModel, formats
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.data.collate import collate_dense
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.data.sampling import NeighborSampler, sampled_block_attention
from dfgnn_tpu_torch.data.synthetic import attention_inputs, pattern_like_batch
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.ops import dense_block, flash_mask, gather, graph_attention
from dfgnn_tpu_torch.ops.bucket import _take, bucket_graph_attention
from dfgnn_tpu_torch.ops.edge_dropout import seed_from_generator
from dfgnn_tpu_torch.parallel import partition_graph
from dfgnn_tpu_torch.scripts import ablation
from dfgnn_tpu_torch.scripts.train_sampled import SampledNet
from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
from dfgnn_tpu_torch.utils import Timer
from dfgnn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from partition_shard_loop import shard_loop

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
    # any head dim runs (f = 48 is no power of two; f = 300 goes in two
    # chunks of 256 columns), and any P (2049: a second window of keys); an
    # empty head dim is refused
    q2049, _, _, adj2049, _ = _inputs(3, 1, 1, 2049, 8)
    for qf, a in [(torch.randn(2, 64, 1, f, device=cuda) * f ** -0.5, adj) for f in (48, 300)] + [
            (q2049, adj2049)]:
        out, lse = flash_mask.flash_mask_fwd(qf, qf, qf, a, want_lse=True)
        want_out, want_lse = flash_mask.flash_mask_fwd_plain(qf, qf, qf, a)
        torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    q0 = torch.zeros(2, 64, 1, 0, device=cuda)
    with pytest.raises(ValueError, match="f >= 1"):
        flash_mask.flash_mask_fwd(q0, q0, q0, adj)


# The tensor-core kernels #1 and #3 at head dims off the powers of two, at
# the single-block P (26, 128) and the streaming P (300, 2048), in both
# dtypes; edge values at f = 12 and 96, dropout at P = 26 and 300.
# (B, h) keep each case small.
NEW_F, NEW_P = (12, 48, 96, 128), (26, 128, 300, 2048)
_BH = {26: (8, 2), 128: (4, 2), 300: (2, 2), 2048: (1, 1)}


def _kernel_case(seed, P, f, dtype):
    B, h = _BH[P]
    q, k, v, adj, val = _inputs(seed, B, h, P, f, with_val=f in (12, 96), dtype=dtype)
    kw = dict(seed=0x5EED, rate=0.4 if P in (26, 300) else 0.0)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(q.shape)
                          .astype(np.float32)).cuda().to(dtype)
    return (q, k, v, adj, val), do, kw


def _f64(*ts):
    return [None if t is None or t.dtype == torch.uint8 else t.double() for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", NEW_P)
@pytest.mark.parametrize("f", NEW_F)
def test_tensor_core_kernels_match_plain(cuda, f, P, dtype):
    """The forward against the plain version; in fp32 the backward against
    the plain version evaluated in fp64 on the same inputs (with edge values
    and unit-scale dO, the fp32 plain version's own rounding of dq reaches
    1e-4 at P = 300; the kernel lies nearer the fp64 value than it)."""
    args, do, kw = _kernel_case(30, P, f, dtype)
    out, lse = flash_mask.flash_mask_fwd(*args, want_lse=True, **kw)
    want_out, want_lse = flash_mask.flash_mask_fwd_plain(*args, **kw)
    got = flash_mask.flash_mask_bwd(*args, want_out, want_lse, do, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
        q, k, v, adj, val = args
        want = flash_mask.flash_mask_bwd_plain(
            *_f64(q, k, v), adj, *_f64(val, want_lse, do),
            flash_mask.bwd_delta(*_f64(do, want_out)), **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.double(), w, **BWD_FP32_TOL)
    else:
        torch.testing.assert_close(out.float(), want_out.float(), rtol=0, atol=3e-2)
        want = flash_mask.flash_mask_bwd_plain(*args, want_lse, do,
                                               flash_mask.bwd_delta(do, want_out), **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            scale = float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=2 ** -6 * scale)


# Head dims past 256: #1 to #3 take them in wide blocks, #4 in chunks of 256
# columns, at the single-block and the streaming P, in both dtypes; edge
# values at f = 257 and 512, dropout at P = 26 and 300 (chip_smoke.py phase
# 26 holds the same grid).
WIDE_F = (257, 384, 512, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", NEW_P)
@pytest.mark.parametrize("f", WIDE_F)
def test_wide_head_kernels_match_plain(cuda, f, P, dtype):
    """#1 to #4 past f = 256 against their plain versions: the forwards at
    the fp32 bar; the fp32 gradients against the plain versions evaluated
    in fp64 at BWD_FP32_TOL, or, where fp32 arithmetic misses that bar on
    these inputs, within twice the fp32 plain version's largest error (at
    P = 2048 with edge values |dq| reaches 1e2 and the fp32 plain version
    lands 3.5e-4 from fp64; 3xTF32 drops each product's lo x lo term, so its
    error ran to 1.44x that: chip_smoke.py's FP32_GRAD_SPREAD); bf16 at the
    bf16 bars."""
    B, h = _BH[P]
    _hold_attention_kernels(40 + f + P, f + P, B, h, P, f, dtype, with_val=f in (257, 512),
                            rate=0.4 if P in (26, 300) else 0.0)


# #1 and #2 past f = 256 run a wide block of 64 rows by up to 512 columns:
# f = 520 and 1030 leave a partial last group of columns, and 1030's rows
# (4120 bytes in fp32, 2060 in bf16) keep only 4-byte alignment; P = 2049
# walks a second window of keys.  Edge values and dropout at every point.
WIDE_FWD_F, WIDE_FWD_P = (520, 1030), (26, 128, 300, 2049)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", WIDE_FWD_P)
@pytest.mark.parametrize("f", WIDE_FWD_F)
def test_wide_forward_block_matches_plain(cuda, f, P, dtype):
    """#1 and #2 in their wide block against their plain versions: out at
    the fp32 bar, or in bf16 at the bf16 bar plus one bf16 rounding of the
    element (2**-8 of it: with edge values at P = 2049 outputs pass 4, where
    one bf16 step, 2**-5, exceeds atol 3e-2; chip_smoke.py's BF16_OUT_TOL);
    #2's scores fp32 beside v of ``dtype``; lse, which the first column
    group writes, at the fp32 bar; rows without an edge 0; a second call
    bitwise equal."""
    B, h = _BH.get(P, (1, 1))
    q, k, v, adj, val = _inputs(90 + f + P, B, h, P, f, with_val=True, dtype=dtype)
    rng = np.random.default_rng(f + P)
    e_row, e_col = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32)).cuda()
                    for _ in range(2))
    kw = dict(seed=0x5EED, rate=0.4)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2.0 ** -8, atol=3e-2))
    no_edge = ~adj.bool().any(-1)
    for fwd, plain, args in ((flash_mask.flash_mask_fwd, flash_mask.flash_mask_fwd_plain,
                              (q, k, v, adj, val)),
                             (flash_mask.flash_add_fwd, flash_mask.flash_add_fwd_plain,
                              (e_row, e_col, v, adj, val))):
        runs = [fwd(*args, want_lse=True, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        want_out, want_lse = plain(*args, **kw)
        out, lse = runs[0]
        assert out.dtype == dtype
        torch.testing.assert_close(out.float(), want_out.float(), **tol)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
        assert not out[no_edge].any()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


def _hold_attention_kernels(seed, grad_seed, B, h, P, f, dtype, *, with_val, rate):
    """#1 to #4 on _inputs(seed, ...) and dO, e_row, e_col drawn from
    grad_seed: the forwards against their plain versions at the fp32 or
    bf16 bar, the gradients as test_wide_head_kernels_match_plain holds
    them."""
    q, k, v, adj, val = _inputs(seed, B, h, P, f, with_val=with_val, dtype=dtype)
    rng = np.random.default_rng(grad_seed)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).cuda().to(dtype)
    e_row, e_col = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32)).cuda()
                    for _ in range(2))
    kw = dict(seed=0x5EED, rate=rate)
    fp32 = dtype == torch.float32
    fwd_tol = dict(rtol=1e-4, atol=1e-5) if fp32 else dict(rtol=0, atol=3e-2)

    def hold_grads(got, plain, args, want_out, want_lse):
        want = plain(*args, want_lse, do, flash_mask.bwd_delta(do, want_out), **kw)
        if not fp32:
            for g, w in zip(got, want):
                scale = float(w.float().abs().max())
                torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=2 ** -6 * scale)
            return
        want64 = plain(*_f64(*args[:3]), args[3], *_f64(args[4], want_lse, do),
                       flash_mask.bwd_delta(*_f64(do, want_out)), **kw)
        for g, w64, w in zip(got, want64, want):
            err = (g.double() - w64).abs()
            if bool((err > 1e-4 + 1e-4 * w64.abs()).any()):
                assert float(err.max()) <= 2 * float((w.double() - w64).abs().max())
            assert bool(torch.isfinite(g).all())

    out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, val, want_lse=True, **kw)
    got = flash_mask.flash_mask_bwd(q, k, v, adj, val, out, lse, do, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), **fwd_tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    assert all(g.dtype == dtype for g in got)
    hold_grads(got, flash_mask.flash_mask_bwd_plain, (q, k, v, adj, val), want_out, want_lse)
    out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, val, want_lse=True, **kw)
    got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, out, lse, do, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), **fwd_tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    hold_grads(got, flash_mask.flash_add_bwd_plain, (e_row, e_col, v, adj, val), want_out,
               want_lse)


# Graphs past P = 2048: the stream blocks walk adj in windows of 2048 keys
# (#3's column pass and #4: rows), so P = 2049 has a second window of one
# tile and P = 4096 two full windows.  (B, h) keep each case small.
BIG_P = {2049: (2, 1), 4096: (1, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", sorted(BIG_P))
def test_large_graph_kernels_match_plain(cuda, P, dtype):
    """#1 to #4 past P = 2048 (f = 64, edge values at 2049, dropout at 4096)
    held as test_wide_head_kernels_match_plain holds them; #5 and #6 (din 72,
    f = 64, #6 with dropout) against their plain versions, rows without an
    edge exactly 0."""
    B, h = BIG_P[P]
    _hold_attention_kernels(70 + P, 71 + P, B, h, P, 64, dtype, with_val=P == 2049,
                            rate=0.4 if P == 4096 else 0.0)
    x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(72 + P, B, h, P, 72, 64, dtype)
    dot = (x, wq, bq, wk, bk, wv, bv, adj)
    kw = dict(slope=0.2, seed=0x5EED, rate=0.4)
    empty = ~adj.bool().any(-1)
    for got, plain in ((flash_mask.flash_layer_dot_fwd(*dot, scale=0.125),
                        lambda: flash_mask.flash_layer_dot_fwd_plain(*dot, scale=0.125)),
                       (flash_mask.flash_layer_add_fwd(x, wq, bq, bk, bv, adj, **kw),
                        lambda: flash_mask.flash_layer_add_fwd_plain(x, wq, bq, bk, bv, adj,
                                                                     **kw))):
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, P, h, 64)
        torch.testing.assert_close(got.float(), plain().float(), **_layer_tol(dtype))
        assert not got[empty].any()


def test_add_bwd_takes_f256_past_p2048(cuda):
    """#4 at f = 256 and P = 4096: the shape whose block, holding every row's
    edge bits, could not launch (208 KB at P = 2048); now its rows go in
    windows of 2048, so it launches at any P."""
    _hold_attention_kernels(75, 76, 1, 1, 4096, 256, torch.float32, with_val=False, rate=0.0)


@pytest.mark.parametrize("B,h,P,f", [(64, 1, 128, 128), (4, 2, 300, 64), (2, 2, 128, 512)])
def test_default_precision_matches_tf32_plain(cuda, B, h, P, f):
    """precision="default" on fp32: #1 to #6 (one TF32 pass) against their
    plain versions with every product's operands rounded to TF32, within a
    TF32 step (2**-10) of each tensor's largest element; "highest" is
    bitwise the call without precision; bf16 ignores the switch.  (#5 and
    #6 only where they take f.)"""
    q, k, v, adj, _ = _inputs(60 + f, B, h, P, f)
    rng = np.random.default_rng(f)
    t = lambda *shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s)
                                               .astype(np.float32)).cuda()
    do, e_row, e_col = t(B, P, h, f), t(B, P, h), t(B, P, h)
    x, bias, ws = t(B, P, 48), [t(h, f, s=0.1) for _ in range(3)], [t(h, 48, f, s=0.15)
                                                                 for _ in range(3)]
    drop = dict(seed=0x5EED, rate=0.4)

    def calls(p, plain):
        fwd = flash_mask.flash_mask_fwd_plain if plain else flash_mask.flash_mask_fwd
        afwd = flash_mask.flash_add_fwd_plain if plain else flash_mask.flash_add_fwd
        out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, want_lse=True, precision=p)
        aout, alse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, want_lse=True, precision=p,
                                              **drop)
        if plain:
            bwd = flash_mask.flash_mask_bwd_plain(q, k, v, adj, None, lse, do,
                                                  flash_mask.bwd_delta(do, out), precision=p)
            abwd = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, None, alse, do,
                                                  flash_mask.bwd_delta(do, aout), precision=p,
                                                  **drop)
        else:
            bwd = flash_mask.flash_mask_bwd(q, k, v, adj, None, out, lse, do, precision=p)
            abwd = flash_mask.flash_add_bwd(e_row, e_col, v, adj, None, aout, alse, do,
                                            precision=p, **drop)
        res = [fwd(q, k, v, adj, precision=p)[0], *bwd,
               afwd(e_row, e_col, v, adj, precision=p, **drop)[0], *abwd]
        if flash_mask.layer_fits("dot", P, f):
            lay = flash_mask.flash_layer_dot_fwd_plain if plain else flash_mask.flash_layer_dot_fwd
            lay_add = (flash_mask.flash_layer_add_fwd_plain if plain
                       else flash_mask.flash_layer_add_fwd)
            res += [lay(x, ws[0], bias[0], ws[1], bias[1], ws[2], bias[2], adj, scale=0.15,
                        precision=p),
                    lay_add(x, ws[0], bias[0], bias[1], bias[2], adj, precision=p, **drop)]
        return res

    got, want = calls("default", False), calls("default", True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2 ** -10 * float(w.abs().max()))
    for a, b in zip(calls("highest", False), calls(None, False)):
        assert torch.equal(a, b)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    assert torch.equal(flash_mask.flash_mask_fwd(qb, kb, vb, adj, precision="default")[0],
                       flash_mask.flash_mask_fwd(qb, kb, vb, adj, precision="highest")[0])


@pytest.mark.parametrize("P", [128, 300])
def test_tensor_core_kernels_are_deterministic(cuda, P):
    """Two launches give bitwise equal results: no atomics, a fixed order of
    sums, the same dropout bits."""
    args, do, kw = _kernel_case(31, P, 96, torch.float32)
    runs = []
    for _ in range(2):
        out, lse = flash_mask.flash_mask_fwd(*args, want_lse=True, **kw)
        runs.append((out, lse, *flash_mask.flash_mask_bwd(*args, out, lse, do, **kw)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [32, 200, 1030])
def test_dot_dropout_mask_is_dropout_factor(cuda, P):
    """With q = k = 0 every edge weighs 1 / degree, and v = one-hot of the key
    reads each weight out: the kernel's kept edges are exactly those of
    dropout_factor (the edge hash), and the kept weights carry its scale.
    At P = f = 1030 the wide block's three column groups, its 4-byte rows
    and its unaligned adj rows."""
    B, h, rate, seed = 2, 2, 0.4, 0x5EED
    _, _, _, adj, _ = _inputs(32, B, h, P, 8)
    zeros = torch.zeros(B, P, h, P, device=cuda)
    onehot = torch.eye(P, device=cuda)[None, :, None, :].expand(B, P, h, P).contiguous()
    out, lse = flash_mask.flash_mask_fwd(zeros, zeros, onehot, adj, want_lse=True, seed=seed,
                                         rate=rate)
    keep = flash_mask.dropout_factor(seed, rate, B, h, P, cuda)        # [B, h, P, P]
    edges = adj[:, None].bool()
    got = out.permute(0, 2, 1, 3)                                     # [B, h, P(row), P(key)]
    assert torch.equal(got != 0, edges & (keep != 0))
    deg = edges.sum(-1, keepdim=True).clamp_min(1).float()
    torch.testing.assert_close(got * deg, torch.where(edges, keep, 0.0), rtol=1e-6, atol=0)


# (B, h, P, f, with_val): the training path's shape, chip_smoke.py's shapes,
# ragged P, the smallest f and the largest shape the kernel takes
BWD_SHAPES = [
    (1024, 1, 128, 128, False),
    (3, 2, 64, 16, True),
    (2, 4, 512, 32, False),
    (2, 2, 100, 64, True),
    (3, 2, 40, 8, False),
    (1, 1, 2048, 256, False),
]
# fp32: the kernel and cuBLAS sum dp over f and the products over P in other
# orders; each sum of O(10) terms differs by a few fp32 ulps, 1e-4 absolute
# leaves a tenfold margin over the expected difference
BWD_FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _bwd_inputs(seed, B, h, P, f, *, with_val=False, dtype=torch.float32):
    q, k, v, adj, val = _inputs(seed, B, h, P, f, with_val=with_val, dtype=dtype)
    out, lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val)
    do = torch.from_numpy(np.random.default_rng(seed + 1000).standard_normal(q.shape)
                          .astype(np.float32)).cuda().to(dtype)
    return q, k, v, adj, val, out, lse, do


def _bwd_plain(q, k, v, adj, val, out, lse, do):
    return flash_mask.flash_mask_bwd_plain(q, k, v, adj, val, lse, do,
                                           flash_mask.bwd_delta(do, out))


@pytest.mark.parametrize("B,h,P,f,with_val", BWD_SHAPES)
def test_bwd_kernel_matches_plain_fp32(cuda, B, h, P, f, with_val):
    args = _bwd_inputs(10, B, h, P, f, with_val=with_val)
    got = flash_mask.flash_mask_bwd(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, _bwd_plain(*args)):
        err = float((g - w).abs().max())
        print(f"{name} B={B} h={h} P={P} f={f} val={with_val}: max abs err {err:.3e}, "
              f"max |grad| {float(w.abs().max()):.3e}")
        torch.testing.assert_close(g, w, **BWD_FP32_TOL)


def test_bwd_kernel_matches_plain_bf16(cuda):
    args = _bwd_inputs(11, 64, 2, 128, 64, dtype=torch.bfloat16)
    got = flash_mask.flash_mask_bwd(*args)
    for g, w in zip(got, _bwd_plain(*args)):
        assert g.dtype == torch.bfloat16
        # ds and p are rounded to bf16 (8 significant bits) before the
        # products and the sums are cast to bf16: a bf16 step of the largest
        # gradient, 2**-6 of it, bounds the difference
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=2 ** -6 * scale)


def test_bwd_launch_counter_counts_kernel_calls_only(cuda):
    args = _bwd_inputs(12, 2, 1, 64, 32)
    flash_mask.BWD_LAUNCHES = 0
    flash_mask.flash_mask_bwd(*args)
    flash_mask.flash_mask_bwd(*(None if t is None else t.cpu() for t in args))
    _bwd_plain(*args)
    assert flash_mask.BWD_LAUNCHES == 1


def test_flash_autograd_on_card_matches_dense(cuda):
    """Autograd through _FlashDot (both kernels) against autograd through
    the dense oracle; ``.sum()`` hands the backward an expanded gradient."""
    q, k, v, adj, val = _inputs(13, 4, 2, 128, 32, with_val=True)
    batch = DenseBatch(adj=adj, node_mask=torch.ones(4, 128, dtype=torch.bool, device=cuda),
                       val=val, n_graphs=4, np_pad=128)
    grads = []
    for fn in (flash_mask.flash_graph_attention, dense_block.dense_graph_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(batch, *leaves).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_gtmodel_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 4)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128, device="cpu")
    x = torch.from_numpy(rng.integers(0, 3, size=(batch.n_graphs * batch.np_pad,)))
    model = GTModel("PATTERN", out_size=2, hidden_size=128, num_layers=8,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        want = model(batch, x)
        flash_mask.LAUNCHES = 0
        got = model.to(cuda)(batch.to(cuda), x.to(cuda))
    assert flash_mask.LAUNCHES == 8
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    """One Adam step of a small GTModel on the card (both kernels) against
    the same step on the CPU (their plain versions): the loss and every
    parameter's gradient."""
    ds = load_batched("ogbg-molhiv", n_graphs=16, quiet=True)
    seen = {}
    for dev in ("cpu", "cuda"):
        model = GTModel("ogbg-molhiv", out_size=1, hidden_size=32, num_layers=2,
                        generator=torch.Generator().manual_seed(0), device=dev)
        state = TrainState.create(model, lr=1e-3, step_lr_every=20, device=dev)
        batch = collate_dense(ds, np.arange(16), np_pad=128, device=dev)
        flash_mask.LAUNCHES = flash_mask.BWD_LAUNCHES = 0
        _, loss = train_step(state, make_loss_fn(model, ds.task, ds.num_classes), *batch)
        seen[dev] = (float(loss), (flash_mask.LAUNCHES, flash_mask.BWD_LAUNCHES),
                     {n: p.grad.cpu() for n, p in model.named_parameters()})
    (cpu_loss, cpu_launches, cpu_grads), (loss, launches, grads) = seen["cpu"], seen["cuda"]
    assert cpu_launches == (0, 0) and launches == (2, 2)
    assert abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    for name, g in grads.items():
        torch.testing.assert_close(g, cpu_grads[name], rtol=1e-3, atol=1e-5)


# Kernels #2 and #4, the additive (GAT) score.  (B, h, P, f, with_val): the
# serving and training shapes, edge values, a long P, ragged P, the smallest f
# and the largest shape the kernels take.
ADD_SHAPES = [
    (1024, 1, 128, 128, False),
    (1024, 1, 128, 64, False),
    (3, 2, 64, 16, True),
    (2, 4, 512, 32, False),
    (2, 2, 100, 64, True),
    (3, 2, 40, 8, False),
    (1, 1, 2048, 256, False),
]
# The cases every #2 test runs beside its own: (B, h, P, f, with_val, holes),
# a padded batch with every fourth graph empty, P = 300 (the streaming block)
# and f = 64 (the GAT training step's head dim).
ADD_CASES = {
    "holes": (64, 1, 128, 128, False, True),
    "P300": (3, 2, 300, 64, True, False),
    "f64": (1024, 1, 128, 64, False, False),
}


def _add_inputs(seed, B, h, P, f, *, with_val=False, dtype=torch.float32, holes=False):
    """Seeded e_row, e_col [B, P, h], v, adj (padded nodes, empty rows; every
    fourth graph empty with ``holes``), val."""
    _, _, v, adj, val = _inputs(seed, B, h, P, f, with_val=with_val, dtype=dtype)
    if holes:
        adj[::4] = 0
        if val is not None:
            val[::4] = 0
    rng = np.random.default_rng(seed + 500)
    e_row, e_col = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32))
                    .cuda().to(dtype) for _ in range(2))
    return e_row, e_col, v, adj, val


def _assert_empty_rows(adj, out, lse):
    """Rows without an edge give out = 0 and lse = -1e30 exactly."""
    empty = adj.sum(-1) == 0  # [B, P]
    assert bool(empty.any())
    assert bool((out[empty] == 0).all())
    assert bool((lse.permute(1, 2, 0)[empty] == flash_mask.NEG_BIG).all())


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("B,h,P,f,with_val,holes",
                         [(*shape, False) for shape in ADD_SHAPES] + list(ADD_CASES.values()))
def test_add_kernels_match_plain_fp32(cuda, B, h, P, f, with_val, holes, rate):
    e_row, e_col, v, adj, val = _add_inputs(20, B, h, P, f, with_val=with_val, holes=holes)
    kw = dict(slope=0.2, seed=12345, rate=rate)
    out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, val, want_lse=True, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    _assert_empty_rows(adj, out, lse)  # empty rows were covered, and are exact
    do = torch.from_numpy(np.random.default_rng(21).standard_normal(v.shape)
                          .astype(np.float32)).cuda()
    got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, want_out, want_lse, do, **kw)
    torch.cuda.synchronize()
    want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, val, want_lse, do,
                                          flash_mask.bwd_delta(do, want_out), **kw)
    for name, g, w in zip(("d e_row", "d e_col", "dv"), got, want):
        err = float((g - w).abs().max())
        print(f"{name} B={B} h={h} P={P} f={f} val={with_val} rate={rate}: max abs err "
              f"{err:.3e}, max |grad| {float(w.abs().max()):.3e}")
        torch.testing.assert_close(g, w, **BWD_FP32_TOL)


@pytest.mark.parametrize("case", [None, *ADD_CASES])
def test_add_kernels_match_plain_bf16(cuda, case):
    B, h, P, f, with_val, holes = ADD_CASES.get(case, (64, 2, 128, 64, False, False))
    e_row, e_col, v, adj, val = _add_inputs(22, B, h, P, f, with_val=with_val,
                                            dtype=torch.bfloat16, holes=holes)
    kw = dict(slope=0.2, seed=7, rate=0.4)
    out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, val, want_lse=True, **kw)
    want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0, atol=3e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    _assert_empty_rows(adj, out, lse)
    do = torch.from_numpy(np.random.default_rng(23).standard_normal(v.shape)
                          .astype(np.float32)).cuda().bfloat16()
    got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, want_out, want_lse, do, **kw)
    want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, val, want_lse, do,
                                          flash_mask.bwd_delta(do, want_out), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        # sums cast to bf16 and p * keep rounded to bf16 before dv's product:
        # a bf16 step of the largest gradient, 2**-6 of it, bounds the difference
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=2 ** -6 * scale)


@pytest.mark.parametrize("B,h,P,f,holes", [
    (2, 2, 64, 64, False),
    (8, 2, 64, 64, True),      # every fourth graph empty
    (2, 1, 300, 256, False),   # the streaming block: the first 256 keys' columns
    (2, 2, 128, 64, False),    # f = 64 < P: the first 64 keys' columns
    (2, 2, 1030, 1030, False),  # the wide block: three column groups, 4-byte rows
])
def test_add_dropout_keeps_the_hash_mask(cuda, B, h, P, f, holes):
    """With v = one-hot columns, out[r, c] = ex[r, c] * keep / l: the kept
    entries are exactly the hash's, on the card as on the CPU."""
    rate = 0.4
    e_row, e_col, _, adj, _ = _add_inputs(24, B, h, P, 64, holes=holes)
    v = torch.eye(P, device=cuda)[:, :f].reshape(1, P, 1, f).expand(B, P, h, f).contiguous()
    out, _ = flash_mask.flash_add_fwd(e_row, e_col, v, adj, seed=99, rate=rate)
    clean, _ = flash_mask.flash_add_fwd(e_row, e_col, v, adj)
    keep = flash_mask.dropout_factor(99, rate, B, h, P, cuda).permute(0, 2, 1, 3)[..., :f]
    live = clean > 0
    assert torch.equal(out[live] != 0, keep[live] != 0)
    frac = float((keep[live] != 0).float().mean())
    assert abs(frac - (1 - rate)) < 0.05, frac
    if holes:
        assert bool((out[::4] == 0).all())


def test_add_launch_counters_count_kernel_calls_only(cuda):
    e_row, e_col, v, adj, _ = _add_inputs(25, 2, 1, 64, 32)
    flash_mask.reset_launch_counts()
    out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, want_lse=True)
    flash_mask.flash_add_fwd(e_row.cpu(), e_col.cpu(), v.cpu(), adj.cpu())
    flash_mask.flash_add_bwd(e_row, e_col, v, adj, None, out, lse, out)
    flash_mask.flash_add_bwd(e_row.cpu(), e_col.cpu(), v.cpu(), adj.cpu(), None, out.cpu(),
                             lse.cpu(), out.cpu())
    assert flash_mask.launch_counts() == (0, 0, 1, 1, 0, 0)
    with pytest.raises(ValueError, match="e_row"):
        flash_mask.flash_add_fwd(e_row[:, :, :1].expand(2, 64, 2), e_col, v, adj)
    with pytest.raises(ValueError, match="dropout"):
        flash_mask.flash_add_fwd(e_row, e_col, v, adj, rate=1.0)


def test_gat_autograd_on_card_matches_dense(cuda):
    """Autograd through _FlashAdd (kernels #2 and #4) against autograd
    through the dense oracle."""
    e_row, e_col, v, adj, val = _add_inputs(26, 4, 2, 128, 32, with_val=True)
    batch = DenseBatch(adj=adj, node_mask=torch.ones(4, 128, dtype=torch.bool, device=cuda),
                       val=val, n_graphs=4, np_pad=128)
    grads = []
    for fn in (flash_mask.flash_graph_attention, dense_block.dense_graph_attention):
        leaves = [t.clone().requires_grad_(True) for t in (e_row, e_col, v)]
        fn(batch, None, None, leaves[2], score="add", e_row=leaves[0],
           e_col=leaves[1]).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", [None, *ADD_CASES])
def test_add_kernels_take_fp32_scores_with_bf16_v(cuda, case):
    """The bf16 GAT path hands kernels #2 and #4 fp32 scores with a bf16 v, as
    the JAX package's bf16 layer does; d e_row and d e_col come back fp32."""
    B, h, P, f, with_val, holes = ADD_CASES.get(case, (64, 2, 128, 64, False, False))
    e_row, e_col, v, adj, val = _add_inputs(27, B, h, P, f, with_val=with_val,
                                            dtype=torch.bfloat16, holes=holes)
    e_row, e_col = (t.float() + 0.01 for t in (e_row, e_col))  # not bf16-exact
    kw = dict(slope=0.2, seed=7, rate=0.4)
    out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, val, want_lse=True, **kw)
    want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0, atol=3e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    _assert_empty_rows(adj, out, lse)
    do = torch.from_numpy(np.random.default_rng(28).standard_normal(v.shape)
                          .astype(np.float32)).cuda().bfloat16()
    got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, want_out, want_lse, do, **kw)
    want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, val, want_lse, do,
                                          flash_mask.bwd_delta(do, want_out), **kw)
    assert [g.dtype for g in got] == [torch.float32, torch.float32, torch.bfloat16]
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=2 ** -6 * scale)


@pytest.mark.parametrize("P,f", [(128, 12), (128, 75), (300, 200), (64, 1)])
def test_add_forward_takes_any_head_dim(cuda, P, f):
    """Kernels #2 and #4 take any f from 1 to 256, as #1 and #3 do, and so
    does the routing."""
    e_row, e_col, v, adj, val = _add_inputs(29, 3, 2, P, f, with_val=True)
    kw = dict(slope=0.2, seed=5, rate=0.4)
    out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, val, want_lse=True, **kw)
    want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    assert flash_mask.flash_takes("add", P, f)
    do = torch.from_numpy(np.random.default_rng(30).standard_normal(v.shape)
                          .astype(np.float32)).cuda()
    flash_mask.reset_launch_counts()
    got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, want_out, want_lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_mask.launch_counts() == (0, 0, 0, 1, 0, 0)
    want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, val, want_lse, do,
                                          flash_mask.bwd_delta(do, want_out), **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_FP32_TOL)


# Kernels #5 and #6, the whole layers.  (B, h, P, din, f, dtype): the GT and
# GAT serving shapes in fp32 and bf16, the GAT step's f=64, several heads with
# din != f, ragged P, the smallest f, bf16 at f=256 and a ragged P past 128;
# then P up to 2048 and off-grid f in fp32 and bf16, and an odd din (not
# 16-byte rows).  Both kernels take every row.
LAYER_SHAPES = [
    (1024, 1, 128, 128, 128, torch.float32),
    (1024, 1, 128, 128, 128, torch.bfloat16),
    (64, 1, 128, 64, 64, torch.float32),
    (3, 2, 64, 48, 16, torch.float32),
    (2, 2, 100, 64, 64, torch.float32),
    (3, 2, 40, 24, 8, torch.float32),
    (2, 1, 128, 256, 256, torch.bfloat16),
    (2, 1, 164, 128, 128, torch.float32),
    (2, 1, 512, 128, 128, torch.float32),
    (2, 1, 512, 128, 128, torch.bfloat16),
    (1, 1, 2048, 64, 256, torch.float32),
    (3, 2, 128, 37, 75, torch.float32),
    (3, 2, 300, 40, 12, torch.bfloat16),
]


def _layer_inputs(seed, B, h, P, din, f, dtype):
    """x [B, P, din] in dtype; the kernels' weights [h, din, f] in dtype
    (variance 1 / din) and fp32 [h, f] vectors; adj with padded nodes and
    empty rows."""
    rng = np.random.default_rng(seed)
    _, _, _, adj, _ = _inputs(seed, B, h, P, 8)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    x = t(rng.standard_normal((B, P, din))).to(dtype)
    ws = [t(rng.standard_normal((h, din, f)) / np.sqrt(din)).to(dtype) for _ in range(3)]
    vecs = [t(rng.standard_normal((h, f)) / np.sqrt(f)) for _ in range(3)]
    return x, ws, vecs, adj


def _layer_tol(dtype):
    # bf16 outputs are O(1) values with 8 significant bits
    return dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=3e-2)


@pytest.mark.parametrize("B,h,P,din,f,dtype", LAYER_SHAPES)
def test_layer_dot_kernel_matches_plain(cuda, B, h, P, din, f, dtype):
    x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(30, B, h, P, din, f, dtype)
    args = (x, wq, bq, wk, bk, wv, bv, adj)
    out = flash_mask.flash_layer_dot_fwd(*args, scale=f ** -0.5)
    torch.cuda.synchronize()
    want = flash_mask.flash_layer_dot_fwd_plain(*args, scale=f ** -0.5)
    assert out.dtype == dtype and out.shape == (B, P, h, f)
    torch.testing.assert_close(out.float(), want.float(), **_layer_tol(dtype))
    assert not out[~adj.bool().any(-1)].any()  # empty and padded rows give 0


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("B,h,P,din,f,dtype", LAYER_SHAPES)
def test_layer_add_kernel_matches_plain(cuda, B, h, P, din, f, dtype, rate):
    x, (w, _, _), (b, al, ar), adj = _layer_inputs(31, B, h, P, din, f, dtype)
    kw = dict(slope=0.2, seed=4321, rate=rate)
    out = flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj, **kw)
    torch.cuda.synchronize()
    want = flash_mask.flash_layer_add_fwd_plain(x, w, b, al, ar, adj, **kw)
    assert out.dtype == dtype and out.shape == (B, P, h, f)
    torch.testing.assert_close(out.float(), want.float(), **_layer_tol(dtype))
    assert not out[~adj.bool().any(-1)].any()  # empty and padded rows give 0


_LAYER_BH = {26: (8, 2), 128: (4, 2), 300: (2, 2), 512: (2, 1), 2048: (2, 1)}


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [26, 128, 300, 512, 2048])
@pytest.mark.parametrize("f", [12, 48, 75, 128, 256])
def test_layer_add_kernel_takes_any_head_dim_and_P(cuda, f, P, dtype, rate):
    """#6 over its whole set (whole block at P <= 128 and f <= 128, the
    stream block elsewhere) against its plain version; every fourth graph
    empty, whose rows are exactly 0."""
    B, h = _LAYER_BH[P]
    x, (w, _, _), (b, al, ar), adj = _layer_inputs(36, B, h, P, 40, f, dtype)
    adj[::4] = 0
    kw = dict(slope=0.2, seed=0x5EED, rate=rate)
    out = flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj, **kw)
    torch.cuda.synchronize()
    want = flash_mask.flash_layer_add_fwd_plain(x, w, b, al, ar, adj, **kw)
    torch.testing.assert_close(out.float(), want.float(), **_layer_tol(dtype))
    assert not out[::4].any() and not out[~adj.bool().any(-1)].any()


@pytest.mark.parametrize("P,f", [(128, 128), (300, 75), (128, 300), (300, 520)])
def test_layer_add_kernel_is_deterministic(cuda, P, f):
    """Two launches of #6 are bitwise equal: e_l and e_r are summed in a
    fixed order, with no atomics (past f = 256 too, where a first launch
    forms them)."""
    x, (w, _, _), (b, al, ar), adj = _layer_inputs(37, 4, 2, P, 64, f, torch.float32)
    runs = [flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj, seed=5, rate=0.4)
            for _ in range(2)]
    assert torch.equal(*runs)


def test_layer_add_dropout_matches_the_decomposed_path(cuda):
    """#6 with dropout equals the projection, the score contractions and
    kernel #2 with the same seed: the two draw the same mask."""
    x, (w, _, _), (b, al, ar), adj = _layer_inputs(32, 64, 2, 128, 64, 32, torch.float32)
    kw = dict(slope=0.2, seed=77, rate=0.4)
    z = torch.einsum("bpd,hdf->bphf", x, w) + b
    el, er = (z * al).sum(-1), (z * ar).sum(-1)
    want, _ = flash_mask.flash_add_fwd(el, er, z, adj, **kw)
    got = flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert not torch.equal(got, flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj))


def test_layer_kernels_refuse_what_does_not_fit(cuda):
    """#5 and #6 take any head dim (f = 300 here) and any P (2049: a second
    window of keys, against their plain versions), and refuse an empty head
    dim and strided tensors."""
    x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(33, 2, 1, 128, 64, 300, torch.float32)
    dot = (x, wq, bq, wk, bk, wv, bv, adj)
    torch.testing.assert_close(flash_mask.flash_layer_dot_fwd(*dot, scale=300 ** -0.5),
                               flash_mask.flash_layer_dot_fwd_plain(*dot, scale=300 ** -0.5),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(flash_mask.flash_layer_add_fwd(x, wq, bq, bk, bv, adj),
                               flash_mask.flash_layer_add_fwd_plain(x, wq, bq, bk, bv, adj),
                               rtol=1e-4, atol=1e-5)
    x, (w, _, _), (b, _, _), adj = _layer_inputs(33, 1, 1, 2049, 16, 8, torch.float32)
    torch.testing.assert_close(
        flash_mask.flash_layer_dot_fwd(x, w, b, w, b, w, b, adj, scale=8 ** -0.5),
        flash_mask.flash_layer_dot_fwd_plain(x, w, b, w, b, w, b, adj, scale=8 ** -0.5),
        rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(flash_mask.flash_layer_add_fwd(x, w, b, b, b, adj),
                               flash_mask.flash_layer_add_fwd_plain(x, w, b, b, b, adj),
                               rtol=1e-4, atol=1e-5)
    w0, b0 = w[..., :0].contiguous(), b[..., :0].contiguous()
    with pytest.raises(ValueError, match="f >= 1"):
        flash_mask.flash_layer_dot_fwd(x, w0, b0, w0, b0, w0, b0, adj, scale=1.0)
    with pytest.raises(ValueError, match="f >= 1"):
        flash_mask.flash_layer_add_fwd(x, w0, b0, b0, b0, adj)
    with pytest.raises(ValueError, match="contiguous"):
        flash_mask.flash_layer_add_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), w, b,
                                       b, b, adj)


@pytest.mark.parametrize("f", [256, 300])
def test_layer_dot_kernel_at_large_scores_holds_fp64(cuda, f):
    """#5 with q, k and v from one weight at scale 1.0 (diagonal scores near
    f) against its function evaluated in fp64 on the same inputs: within
    the fp32 bar or, where fp32 arithmetic misses it at such scores, within
    twice the fp32 plain version's largest error.  f = 256 takes the
    whole-head path, f = 300 the chunked one."""
    x, (w, _, _), (b, _, _), adj = _layer_inputs(33, 2, 1, 128, 64, f, torch.float32)
    dot = (x, w, b, w, b, w, b, adj)
    got = flash_mask.flash_layer_dot_fwd(*dot, scale=1.0)
    torch.cuda.synchronize()
    want = flash_mask.flash_layer_dot_fwd_plain(*dot, scale=1.0)
    x64, w64, b64 = _f64(x, w, b)
    z64 = torch.einsum("bpd,hdf->bphf", x64, w64) + b64
    want64 = flash_mask.flash_mask_fwd_plain(z64, z64, z64, adj)[0]
    err, plain_err = (float((o.double() - want64).abs().max()) for o in (got, want))
    print(f"f={f}: #5 {err:.3e} from fp64, the fp32 plain version {plain_err:.3e}")
    if bool(((got.double() - want64).abs() > 1e-5 + 1e-4 * want64.abs()).any()):
        assert err <= 2 * plain_err


# Head dims past 256: #5 and #6 take them in chunks of 128 columns (#5 past
# P = 128 in chunks of 256), at the single-block and the streaming P, in
# both dtypes; #6 with dropout at P = 26 and 300; every fourth graph empty
# where B >= 4 (chip_smoke.py phase 27 holds the same grid at both fp32
# precisions).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", NEW_P)
@pytest.mark.parametrize("f", WIDE_F)
def test_wide_layer_kernels_match_plain(cuda, f, P, dtype):
    B, h = _BH[P]
    x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(50 + f + P, B, h, P, 72, f, dtype)
    if B >= 4:
        adj[::4] = 0
    dot = (x, wq, bq, wk, bk, wv, bv, adj)
    kw = dict(slope=0.2, seed=0x5EED, rate=0.4 if P in (26, 300) else 0.0)
    empty = ~adj.bool().any(-1)
    for got, plain in ((flash_mask.flash_layer_dot_fwd(*dot, scale=f ** -0.5),
                        lambda: flash_mask.flash_layer_dot_fwd_plain(*dot, scale=f ** -0.5)),
                       (flash_mask.flash_layer_add_fwd(x, wq, bq, bk, bv, adj, **kw),
                        lambda: flash_mask.flash_layer_add_fwd_plain(x, wq, bq, bk, bv, adj,
                                                                     **kw))):
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, P, h, f)
        torch.testing.assert_close(got.float(), plain().float(), **_layer_tol(dtype))
        assert not got[empty].any()  # empty and padded rows give 0


# The wide paths of #3 and #5: #3 past f = 256 in its whole-graph wide block
# (P <= 128) and its wide row and column passes (past it); #5 past f = 256
# and P = 128 through its projection launch and wide attention block (at
# P <= 128 its whole block).  fp32 at both precisions and bf16, each against
# its plain version: fp32 gradients as test_wide_head_kernels_match_plain
# holds them, "default" within a TF32 step of each tensor's largest element
# of the TF32-rounded plain version, bf16 at the bf16 bars.
@pytest.mark.parametrize("prec", ["highest", "default", "bf16"])
@pytest.mark.parametrize("P", [26, 128, 300])
@pytest.mark.parametrize("f", [384, 512])
def test_wide_paths_of_kernels_3_and_5_match_plain(cuda, f, P, prec):
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    precision = "default" if prec == "default" else None
    step = 2 ** -10 if prec == "default" else 2 ** -6  # of the largest element
    B, h = _BH[P]
    q, k, v, adj, val = _inputs(60 + f + P, B, h, P, f, with_val=f == 512, dtype=dtype)
    do = torch.from_numpy(np.random.default_rng(f + P).standard_normal(q.shape)
                          .astype(np.float32)).cuda().to(dtype)
    kw = dict(seed=0x5EED, rate=0.0 if P == 128 else 0.4, precision=precision)
    want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val, **kw)
    got = flash_mask.flash_mask_bwd(q, k, v, adj, val, want_out, want_lse, do, **kw)
    torch.cuda.synchronize()
    want = flash_mask.flash_mask_bwd_plain(q, k, v, adj, val, want_lse, do,
                                           flash_mask.bwd_delta(do, want_out), **kw)
    if prec == "highest":
        want64 = flash_mask.flash_mask_bwd_plain(*_f64(q, k, v), adj, *_f64(val, want_lse, do),
                                                 flash_mask.bwd_delta(*_f64(do, want_out)), **kw)
        for g, w64, w in zip(got, want64, want):
            err = (g.double() - w64).abs()
            if bool((err > 1e-4 + 1e-4 * w64.abs()).any()):
                assert float(err.max()) <= 2 * float((w.double() - w64).abs().max())
            assert bool(torch.isfinite(g).all())
    else:
        for g, w in zip(got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=step * float(w.float().abs().max()))
    x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(70 + f + P, B, h, P, 72, f, dtype)
    args = (x, wq, bq, wk, bk, wv, bv, adj)
    out = flash_mask.flash_layer_dot_fwd(*args, scale=f ** -0.5, precision=precision)
    torch.cuda.synchronize()
    want = flash_mask.flash_layer_dot_fwd_plain(*args, scale=f ** -0.5, precision=precision)
    assert out.dtype == dtype and out.shape == (B, P, h, f)
    tol = (dict(rtol=0, atol=step * float(want.abs().max())) if prec == "default"
           else _layer_tol(dtype))
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert not out[~adj.bool().any(-1)].any()  # empty and padded rows give 0


@pytest.mark.parametrize("P,f", [(128, 512), (300, 384), (2176, 384)])
def test_wide_bwd_is_deterministic(cuda, P, f):
    """#3's wide blocks (the whole-graph one at P = 128, the row and column
    passes past it, in windows past P = 2048) give bitwise equal gradients
    on two launches: no atomics, every sum in a fixed order, the same
    dropout bits."""
    B, h = (2, 2) if P <= 300 else (1, 1)
    q, k, v, adj, val = _inputs(80 + P, B, h, P, f, with_val=True)
    do = torch.from_numpy(np.random.default_rng(P).standard_normal(q.shape)
                          .astype(np.float32)).cuda()
    kw = dict(seed=0x5EED, rate=0.3)
    out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, val, want_lse=True, **kw)
    runs = [flash_mask.flash_mask_bwd(q, k, v, adj, val, out, lse, do, **kw) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wide_layer_dot_counts_one_launch_a_call(cuda):
    """Past f = 256 and P = 128, #5 launches twice a call (the projection,
    then the attention) and counts one; its scratch is allocated only
    there."""
    for P, scratch in ((128, None), (300, (3, 2, 304, 1, 384))):
        assert flash_mask.layer_dot_scratch_shape(2, P, 1, 300) == scratch
        x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(5, 2, 1, P, 40, 300, torch.float32)
        flash_mask.reset_launch_counts()
        for _ in range(3):
            flash_mask.flash_layer_dot_fwd(x, wq, bq, wk, bk, wv, bv, adj, scale=0.05)
        torch.cuda.synchronize()
        assert flash_mask.launch_counts() == (0, 0, 0, 0, 3, 0)


def test_wide_entry_points_refuse_mismatched_buffers(cuda):
    """The C entry points refuse, without a launch, what the wrapper's host
    plans would give them if the plans and the C dispatch disagreed: #5's
    scratch one element short past f = 256 and P = 128; #3 without delta
    where its passes read it, and without out where its whole-graph wide
    block forms delta."""
    lib, invalid = flash_mask._library(), 1  # cudaErrorInvalidValue
    stream = torch.cuda.current_stream().cuda_stream
    x, (wq, wk, wv), (bq, bk, bv), adj = _layer_inputs(5, 2, 1, 300, 40, 300, torch.float32)
    out = torch.empty((2, 300, 1, 300), device="cuda")
    scratch = torch.empty(flash_mask.layer_dot_scratch_shape(2, 300, 1, 300), device="cuda")
    ptrs = [t.data_ptr() for t in (x, wq, bq, wk, bk, wv, bv, adj, out, scratch)]
    for n, want in ((scratch.numel() - 1, invalid), (scratch.numel(), 0)):
        assert lib.dfgnn_flash_layer_dot_fwd(0, *ptrs, n, 2, 300, 1, 40, 300, 0.05, 0,
                                             stream) == want
    for P, f, with_delta, with_out in ((300, 300, False, True), (128, 300, True, False),
                                       (128, 128, False, True)):
        q, k, v, adj, _ = _inputs(6, 1, 1, P, f)
        lse = torch.zeros((1, 1, P), device="cuda")
        grads = [torch.empty_like(q) for _ in range(3)]
        err = lib.dfgnn_flash_mask_bwd(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), None, lse.data_ptr(),
            lse.data_ptr() if with_delta else None, q.data_ptr() if with_out else None,
            q.data_ptr(), *[g.data_ptr() for g in grads], 1, P, 1, f, 0, 0, 0, 1.0, 0, stream)
        assert err == invalid, (P, f)
    torch.cuda.synchronize()


@pytest.mark.parametrize("conv", ["gt", "gat"])
def test_wide_fused_layer_autograd_on_card_matches_cpu(cuda, conv):
    """A flash_fused conv at head dim 300 (one head): its forward and
    backward on the card (#5, then #1 and #3; or #6, then #2 and #4) against
    the same conv on the CPU (the plain versions)."""
    rng = np.random.default_rng(38)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 4)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128, device="cpu")
    x = torch.from_numpy(rng.standard_normal((4 * 128, 40)).astype(np.float32))
    seen = {}
    for dev in ("cpu", "cuda"):
        layer = make_conv(conv, 40, 300, 1, generator=torch.Generator().manual_seed(0),
                          device=dev)
        xd = x.to(dev).detach().requires_grad_(True)
        flash_mask.reset_launch_counts()
        out = layer(batch.to(dev), xd, impl="flash_fused")
        (out * torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)).sum().backward()
        seen[dev] = (out.detach().cpu(), flash_mask.launch_counts(),
                     [t.grad.cpu() for t in (xd, *layer.parameters())])
    want = (1, 1, 0, 0, 1, 0) if conv == "gt" else (0, 0, 1, 1, 0, 1)
    assert seen["cpu"][1] == (0,) * 6 and seen["cuda"][1] == want
    torch.testing.assert_close(seen["cuda"][0], seen["cpu"][0], rtol=1e-4, atol=1e-5)
    for g, w in zip(seen["cuda"][2], seen["cpu"][2]):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("conv", ["gt", "gat"])
def test_fused_layer_autograd_on_card_matches_cpu(cuda, conv):
    """A flash_fused conv's forward and backward on the card (#5, then #1 and
    #3; or #6, then #2 and #4) against the same conv on the CPU (the plain
    versions): the output and every gradient."""
    rng = np.random.default_rng(34)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 4)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128, device="cpu")
    x = torch.from_numpy(rng.standard_normal((4 * 128, 32)).astype(np.float32))
    seen = {}
    for dev in ("cpu", "cuda"):
        layer = make_conv(conv, 32, 32, 2, generator=torch.Generator().manual_seed(0),
                          device=dev)
        xd = x.to(dev).detach().requires_grad_(True)
        flash_mask.reset_launch_counts()
        out = layer(batch.to(dev), xd, impl="flash_fused")
        (out * torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)).sum().backward()
        seen[dev] = (out.detach().cpu(), flash_mask.launch_counts(),
                     [t.grad.cpu() for t in (xd, *layer.parameters())])
    want = (1, 1, 0, 0, 1, 0) if conv == "gt" else (0, 0, 1, 1, 0, 1)
    assert seen["cpu"][1] == (0,) * 6 and seen["cuda"][1] == want
    torch.testing.assert_close(seen["cuda"][0], seen["cpu"][0], rtol=1e-4, atol=1e-5)
    for g, w in zip(seen["cuda"][2], seen["cpu"][2]):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def _bf16_gat_auto(f, launches=(0, 0, 0, 0, 0, 1)):
    rng = np.random.default_rng(35)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 8)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128)
    x = torch.from_numpy(rng.standard_normal((8 * 128, 64)).astype(np.float32)).cuda()
    layer = make_conv("gat", 64, f, 1, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    ref = make_conv("gat", 64, f, 1, generator=torch.Generator().manual_seed(0))
    flash_mask.reset_launch_counts()
    with torch.inference_mode():
        out = layer(batch, x)
        assert flash_mask.launch_counts() == launches
        want = ref(batch, x, impl="flash")
    assert out.dtype == torch.bfloat16
    err = float((out.float() - want).abs().max()) / float(want.abs().max())
    assert err < 5e-2, err


def test_bf16_gat_auto_runs_kernel_six(cuda):
    """GATConv in bf16 on a DenseBatch: auto is the whole-layer kernel; its
    output is bf16 and within a bf16 step of the fp32 layer's."""
    _bf16_gat_auto(64)


def test_bf16_gat_auto_follows_the_width_bound(cuda):
    """Past GAT_FUSED_MAX_F (head dim 320 here, past 256) bf16 auto takes
    the flash route (one #2 launch), where #6 lost on the card; at the
    bound, #6."""
    from dfgnn_tpu_torch.models import conv as conv_mod

    _bf16_gat_auto(conv_mod.GAT_FUSED_MAX_F)
    _bf16_gat_auto(320, launches=(0, 0, 1, 0, 0, 0))


GATHER_CASES = [  # (table rows, row shape, dtype, rows gathered, chunk, lookahead)
    (1 << 18, (128,), torch.float32, 1 << 20, 512, 15),   # the probe's main shape
    (5000, (256,), torch.float32, 12345, 256, 7),         # 1 KB rows, M not a chunk multiple
    (5000, (2, 64), torch.bfloat16, 777, 1024, 31),       # bf16, fewer rows than a chunk
    (64, (4,), torch.float32, 3, 512, 7),                  # 16-byte rows
    (64, (1024,), torch.float32, 100, 8, 7),               # 4 KB rows: pieces past a block
]


@pytest.mark.parametrize("N,shape,dtype,M,chunk,la", GATHER_CASES)
def test_gather_rows_kernel_equals_plain(cuda, N, shape, dtype, M, chunk, la):
    gen = torch.Generator(device="cuda").manual_seed(N)
    tbl = torch.randn((N, *shape), device=cuda, generator=gen).to(dtype)
    idx = torch.randint(0, N, (M,), device=cuda, generator=gen, dtype=torch.int32)
    gather.reset_launch_counts()
    out = gather.gather_rows(tbl, idx, chunk=chunk, lookahead=la)
    torch.cuda.synchronize()
    assert gather.launch_counts() == (1, 0)
    assert torch.equal(out, gather.gather_rows_plain(tbl, idx))


@pytest.mark.parametrize("S,f", [(512, 128), (1024, 128), (4096, 128), (300, 12), (7, 64),
                                 (20000, 128), (3000, 12), (33, 256)])
def test_take_rows_kernel_equals_plain(cuda, S, f):
    gen = torch.Generator(device="cuda").manual_seed(S)
    slab = torch.randn((S, f), device=cuda, generator=gen)
    idx = torch.randint(-2 * S, 2 * S, (70001,), device=cuda, generator=gen, dtype=torch.int32)
    gather.reset_launch_counts()
    out = gather.take_rows(slab, idx)
    torch.cuda.synchronize()
    assert gather.launch_counts() == (0, 1)
    assert torch.equal(out, gather.take_rows_plain(slab, idx))


def test_gather_kernels_refuse_what_they_do_not_take(cuda, monkeypatch):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        gather.gather_rows(torch.zeros((8, 3), device=cuda), ids)
    with pytest.raises(ValueError, match="lookahead"):
        gather.gather_rows(torch.zeros((8, 4), device=cuda), ids, lookahead=3)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(torch.zeros((8, 4), device=cuda), ids.long())
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        gather.take_rows(torch.zeros((8, 3), device=cuda), ids)
    # a slab past what int32 ids reach would take 32 GB here: a lower limit
    # shows the refusal
    monkeypatch.setattr(gather, "TAKE_MAX_ROWS", 100)
    gather.take_rows(torch.zeros((100, 4), device=cuda), ids)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        gather.take_rows(torch.zeros((101, 4), device=cuda), ids)


def _bucket_case(device):
    rng = np.random.default_rng(5)
    n = 3000
    rows = np.repeat(np.arange(n), rng.integers(0, 40, n))
    rows = np.concatenate([rows, np.full(700, 11)])  # one row past the segment split
    cols = rng.integers(0, n, rows.size)
    g = Graph.from_coo(rows, cols, n, device=device)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
    return g, t(n, 2, 32), t(n, 2, 32), t(n, 2, 32), t(n, 2), t(n, 2), t(n, 2, 32)


@pytest.mark.parametrize("blocked", [False, True])
def test_bucket_path_on_card_matches_cpu(cuda, blocked):
    """The bucket forward and its custom backward, with dropout, on the card
    against the same torch ops on the CPU."""
    results = []
    for dev in ("cpu", cuda):
        g, q, k, v, er, ec, do = _bucket_case(dev)
        bg = formats.build_buckets(g, with_transpose=True,
                                   src_block_rows=1024 if blocked else None)
        res = []
        for score in ("dot", "add"):
            ins = [t.clone().requires_grad_(True) for t in ((q, k, v) if score == "dot"
                                                              else (er, ec, v))]
            kw = dict(e_row=ins[0], e_col=ins[1]) if score == "add" else {}
            qk = ins[:2] if score == "dot" else (None, None)
            out = graph_attention(bg, *qk, ins[2], score=score, dropout_rate=0.3,
                                  dropout_generator=torch.Generator().manual_seed(3), **kw)
            res += [out, *torch.autograd.grad(out, ins, do)]
        results.append([r.detach().cpu() for r in res])
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_bucket_path_on_card_is_deterministic(cuda):
    """Two runs of the bucket forward and its custom backward on the card,
    on a graph with a row past the segment split, are bitwise equal: the
    wide rows' segment sums run in a fixed order (no atomics)."""
    g, q, k, v, _, _, do = _bucket_case(cuda)
    bg = formats.build_buckets(g, with_transpose=True)
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = graph_attention(bg, *ins, score="dot")
        runs.append([out, *torch.autograd.grad(out, ins, do)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _sampled_case(device):
    """One sampled batch of a 400-node graph (fanouts 4, 4), its input rows,
    labels, and a SampledNet (hidden 16) from one seed."""
    rng = np.random.default_rng(7)
    n, bs = 400, 128
    rows = np.repeat(np.arange(n), rng.integers(0, 12, n))
    g = Graph.from_coo(rows, rng.integers(0, n, rows.size), n, device=device)
    blocks, sup = NeighborSampler(g).sample_localized(
        np.arange(bs), [4, 4], seed=3, pad_to=[bs, bs * 5], support_pad=bs * 25)
    x = torch.from_numpy(np.concatenate([rng.standard_normal((n, 16)), np.zeros((1, 16))]
                                        ).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 3, bs)).to(device)
    model = SampledNet(16, 16, 3, generator=torch.Generator().manual_seed(0), device=device)
    return [b.to(device) for b in blocks], _take(x, torch.from_numpy(sup).to(device)), y, model


def test_sampled_path_on_card_matches_cpu(cuda):
    """Sampled-block attention on both scores, and a SampledNet step (loss,
    gradients, the loss after one Adam update), on the card against the CPU."""
    results = []
    flash_mask.reset_launch_counts()
    for dev in ("cpu", cuda):
        blocks, x_sup, y, model = _sampled_case(dev)
        blk = blocks[-1]
        h = x_sup.reshape(x_sup.shape[0], 2, 8)
        e = x_sup[:, :2]
        res = [sampled_block_attention(blk, h, h, h),
               sampled_block_attention(blk, None, None, h, score="add", e_row=e, e_col=e)]
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        loss_fn = lambda: torch.nn.functional.cross_entropy(model(blocks, x_sup)[:128], y)
        loss = loss_fn()
        loss.backward()
        res += [loss.detach()] + [p.grad for p in model.parameters()]
        opt.step()
        # the loss after the update: Adam turns the k bias's zero gradient
        # (softmax ignores a per-row shift) into noise-signed steps, which the
        # output does not see
        with torch.no_grad():
            res.append(loss_fn())
        results.append([r.cpu() for r in res])
    assert flash_mask.launch_counts() == (0,) * 6  # the bucket path is torch ops
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_partition_shard_loop_on_card(cuda):
    """Every shard's local forward of three plans (all-gather, halo, bfs
    reorder with halo and dropout) on the card: equal to the unpartitioned
    bucket forward there and to the same loop on the CPU."""
    rng = np.random.default_rng(8)
    n = 700
    rows = np.repeat(np.arange(n), rng.integers(0, 20, n))
    cols = rng.integers(0, n, rows.size)
    g = Graph.from_coo(rows, cols, n, device="cpu")
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 2, 16)).astype(np.float32))
               for _ in range(3))
    seed = seed_from_generator(torch.Generator().manual_seed(4))
    flash_mask.reset_launch_counts()
    for kw, rate in ((dict(), 0.0), (dict(halo=True), 0.0),
                     (dict(reorder="bfs", halo=True), 0.1)):
        pg = partition_graph(g, 4, **kw)
        got = shard_loop(pg, q.cuda(), k.cuda(), v.cuda(), seed=seed, rate=rate)
        want = bucket_graph_attention(formats.build_buckets(g.to(cuda)), q.cuda(), k.cuda(),
                                      v.cuda(), dropout_rate=rate,
                                      dropout_generator=torch.Generator().manual_seed(4))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.cpu(), shard_loop(pg, q, k, v, seed=seed, rate=rate),
                                   rtol=1e-4, atol=1e-5)
    assert flash_mask.launch_counts() == (0,) * 6  # the bucket path is torch ops


def test_checkpoint_roundtrip_on_card(cuda, tmp_path):
    model = make_conv("gt", 8, 8, 2, generator=torch.Generator().manual_seed(0), device=cuda)
    state = TrainState.create(model, lr=1e-2, device=cuda)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.opt.step()
    saved = {"model": model.state_dict(), "opt": state.opt.state_dict()}
    save_checkpoint(str(tmp_path), saved, step=5)
    restored, step = restore_checkpoint(str(tmp_path), saved)
    assert step == 5
    for key, t in saved["model"].items():
        got = restored["model"][key]
        assert got.device == t.device and torch.equal(got, t)
    for pid, st in saved["opt"]["state"].items():
        for key, t in st.items():
            assert torch.equal(restored["opt"]["state"][pid][key], t)


def test_ablation_batched_rows_on_card_match_cpu(cuda):
    flash_mask.reset_launch_counts()
    on_card = ablation.batched_rows(8, 32, 2, rng=np.random.default_rng(0), device=cuda, iters=2)
    on_cpu = ablation.batched_rows(8, 32, 2, rng=np.random.default_rng(0), device="cpu")
    for got, want in zip(on_card, on_cpu):
        assert got["impl"] == want["impl"] and got["ok"] and want["ok"]
        assert got["ms"] > 0 and got["peak_mib"] >= 0 and got["n_edges"] == want["n_edges"]
        np.testing.assert_allclose(got["out"], want["out"], rtol=1e-3, atol=1e-4)
    # 3 warmups and 2 timed calls a row, each one launch of the row's kernel
    launches = {r["impl"]: r["launches"] for r in on_card}
    assert launches == {"reference": [0] * 6, "dense": [0] * 6, "flash": [5, 0, 0, 0, 0, 0],
                        "flash_fused": [0, 0, 0, 0, 5, 0]}
    assert flash_mask.launch_counts() == (5, 0, 0, 0, 5, 0)


def test_timer_waits_for_a_launched_kernel(cuda):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with Timer(device=cuda) as waited:
        start.record()
        torch.cuda._sleep(100_000_000)  # a spin kernel of about 50 ms
        end.record()
    assert end.query()  # the Timer synchronised: the kernel is done
    kernel_ms = start.elapsed_time(end)
    assert kernel_ms > 10.0 and waited.elapsed_ms >= kernel_ms
    with Timer(device="cpu") as enqueued:
        torch.cuda._sleep(100_000_000)
    torch.cuda.synchronize()
    assert enqueued.elapsed_ms < kernel_ms / 2  # the clock alone sees only the launch


def test_dist_plans_on_card_match_unpartitioned(cuda):
    """A 4-rank gloo world on this one card: every plan flavour's gathered
    output and gradients of sum(out ** 2) against the unpartitioned bucket
    path (the default plan deals its 400-wide row as shared segments)."""
    from dist_world import CARD_PLANS, card_plans, start_world

    res = start_world(card_plans, 4, timeout=300).results()
    assert set(res) == {name for name, *_ in CARD_PLANS} and res["default"]["shared"]
    for name, r in res.items():
        for i, (got, want) in enumerate(zip(r["got"], r["want"])):
            tol = dict(rtol=1e-4, atol=1e-5) if i == 0 else dict(rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(got, want, **tol, err_msg=f"{name} [{i}]")


def test_gloo_collectives_on_card_match_cpu(cuda):
    """The collectives of parallel.comm under gloo on CUDA tensors give what
    they give on the same CPU tensors, forward and backward."""
    from dist_world import card_collectives, start_world

    res = start_world(card_collectives, 4, timeout=120).results()
    for name, pair in res.items():
        if name == "all_reduce_max":
            np.testing.assert_array_equal(pair[0], pair[1])
            continue
        for a, b in zip(*pair):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
