"""The port's neighbour sampler, sampled-block attention and sampled
trainer's model against the JAX package's (CPU).

The draws must be the JAX package's bitwise: both sample with their own
build of one C++ xorshift reservoir, and the JAX package's library must
have loaded (else it would fall back to numpy's ``rng.choice`` and a
mismatch would read as the port's fault).  JAX's attention and training
run under ``jax.jit``, once per cached helper.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from torch.utils._python_dispatch import TorchDispatchMode

from dfgnn_tpu import native
from dfgnn_tpu.data import sampling as jax_sampling
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu.models import make_conv as jax_make_conv
from dfgnn_tpu.models.conv import GTConv as JaxGTConv
from dfgnn_tpu_torch import native as torch_native
from dfgnn_tpu_torch import weights
from dfgnn_tpu_torch.data.sampling import NeighborSampler, _localize, sampled_block_attention
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.ops import graph_attention
from dfgnn_tpu_torch.ops.bucket import _take
from dfgnn_tpu_torch.scripts.train_sampled import SampledNet
from helpers import random_graph_coo

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _graphs(rows, cols, n):
    return JaxGraph.from_coo(rows, cols, n), Graph.from_coo(rows, cols, n, device="cpu")


def _degree_graph(fanout):
    """Rows of every degree from 0 to 3 * fanout (below, at and above the
    fanout, and zero), 4 rows each, with distinct neighbours."""
    rng = np.random.default_rng(fanout)
    degs = np.repeat(np.arange(3 * fanout + 1), 4)
    n = degs.size
    rows = np.repeat(np.arange(n), degs)
    cols = np.concatenate([rng.choice(n, d, replace=False) for d in degs])
    return (*_graphs(rows, cols, n), degs)


@functools.cache
def _sampled_graph(n=200, deg=6, seed=0):
    rows, cols, _ = random_graph_coo(np.random.default_rng(seed), n, deg, zero_deg_frac=0.0)
    return _graphs(rows, cols, n)


def _same_block(jblk, tblk):
    """Every array of two packages' blocks equal, bitwise."""
    jb, tb = jblk.bg.buckets[0], tblk.bg.buckets[0]
    for name in ("nbr", "emask", "row_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(tblk.seeds), np.asarray(jblk.seeds))
    assert (tblk.n_seeds, tb.width, tb.n_rows, tb.row_chunk) == (
        jblk.n_seeds, jb.width, jb.n_rows, jb.row_chunk)
    assert (tblk.bg.n_nodes, tblk.bg.n_edges) == (jblk.bg.n_nodes, jblk.bg.n_edges)


@pytest.mark.parametrize("fanout,seeds,seed", [
    (4, "all", 0),              # degrees 0 to 12 against fanout 4
    (8, "repeated", 12345),     # repeated seeds, zero-degree ones among them
    (1, "high", 2 ** 63 + 5),   # a seed past 2**63; fanout 1
])
def test_sample_layer_draws_bitwise(fanout, seeds, seed):
    assert native.get_lib() is not None, "the JAX package's native sampler must load"
    jg, tg, degs = _degree_graph(fanout)
    n = degs.size
    ids = {"all": np.arange(n),
           "repeated": np.r_[np.arange(0, n, 3), [0, 0, 5, 5, n - 1, n - 1, 1, 2, 3]],
           "high": np.arange(n)[::-1]}[seeds]
    jblk = jax_sampling.NeighborSampler(jg).sample_layer(ids, fanout, seed)
    tblk = NeighborSampler(tg).sample_layer(ids, fanout, seed)
    _same_block(jblk, tblk)
    # rows at or below the fanout are copied whole; wider rows keep fanout lanes
    mask = np.asarray(tblk.bg.buckets[0].emask)[: len(ids)]
    np.testing.assert_array_equal(mask.sum(1), np.minimum(degs[ids], fanout))


def test_host_library_matches_jax_native():
    """The port's host library against the JAX package's, bitwise: the
    sampler's draws (degrees 0 to 3x the fanout, repeated seeds, a seed past
    2**63) and the CSR sort of unsorted rows with isolated tail nodes."""
    assert native.get_lib() is not None, "the JAX package's native library must load"
    _, tg, degs = _degree_graph(4)
    indptr, cols = tg.indptr.numpy(), tg.cols[: tg.n_edges].numpy()
    n = degs.size
    for ids, seed in ((np.arange(n), 0), (np.r_[np.arange(0, n, 3), [0, 0, n - 1]], 12345),
                      (np.arange(n)[::-1], 2 ** 63 + 5)):
        got = torch_native.sample_neighbors(ids, indptr, cols, 4, n, seed)
        want = native.sample_neighbors_native(ids, indptr, cols, 4, n, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(15)
    rows, cols = rng.integers(0, 95, 2000), rng.integers(0, 100, 2000)
    for g, w in zip(torch_native.csr_from_coo(rows, cols, 100),
                    native.csr_from_coo(rows, cols, 100)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pad_to", [None, (16, 40)])  # (16, 40) truncates the frontier
def test_sample_matches_jax(pad_to):
    jg, tg = _sampled_graph()
    seeds = np.arange(3, 60, 2)
    jblocks = jax_sampling.NeighborSampler(jg).sample(seeds, [4, 3], seed=7, pad_to=pad_to)
    tblocks = NeighborSampler(tg).sample(seeds, [4, 3], seed=7, pad_to=pad_to)
    assert len(tblocks) == 2
    for jb, tb in zip(jblocks, tblocks):
        _same_block(jb, tb)
    if pad_to is not None:
        assert [b.n_seeds for b in tblocks] == list(pad_to)


@pytest.mark.parametrize("support_pad", [128 * 25, 200])  # 200 truncates the support
def test_sample_localized_matches_jax(support_pad):
    jg, tg = _sampled_graph()
    seeds = np.arange(128)
    kw = dict(seed=3, pad_to=[128, 128 * 5], support_pad=support_pad)
    jblocks, jsup = jax_sampling.NeighborSampler(jg).sample_localized(seeds, [4, 4], **kw)
    tblocks, tsup = NeighborSampler(tg).sample_localized(seeds, [4, 4], **kw)
    np.testing.assert_array_equal(tsup, np.asarray(jsup))
    for jb, tb in zip(jblocks, tblocks):
        _same_block(jb, tb)


def test_localize_matches_jax():
    rng = np.random.default_rng(4)
    ref = np.r_[rng.permutation(50)[:30], np.full(10, 99)]
    ids = rng.integers(0, 60, (7, 5))
    for ref_real in (30, 12, 0):
        got = _localize(ids, ref, ref_real, 40)
        want = jax_sampling._localize(ids, ref, ref_real, 40)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    loc, found = _localize(ids, ref, 0, 40)
    assert (loc == 40).all() and not found.any()


@functools.cache
def _jax_attention(score):
    """JAX's sampled_block_attention and its conv (GTConv for the dot score,
    GATConv for the additive one, 2 heads) on one localized block."""
    jg, _ = _sampled_graph()
    jblocks, _ = jax_sampling.NeighborSampler(jg).sample_localized(
        np.arange(128), [4, 4], seed=5, pad_to=[128, 640], support_pad=3200)
    blk = jblocks[0]
    rng = np.random.default_rng(6)
    rows, h, f = 640, 2, 8
    arrs = [rng.standard_normal((rows, h, f)).astype(np.float32) for _ in range(3)]
    es = [rng.standard_normal((rows, h)).astype(np.float32) for _ in range(2)]
    x = rng.standard_normal((rows, 12)).astype(np.float32)
    if score == "dot":
        attn = jax.jit(lambda b, q, k, v: jax_sampling.sampled_block_attention(b, q, k, v))(
            blk, *arrs)
    else:
        attn = jax.jit(lambda b, v, a, c: jax_sampling.sampled_block_attention(
            b, None, None, v, score="add", e_row=a, e_col=c))(blk, arrs[2], *es)
    conv = jax_make_conv("gt" if score == "dot" else "gat", out_size=8, num_heads=2)
    params = jax.jit(lambda b, xx: conv.init(jax.random.key(0), b, xx))(blk, jnp.asarray(x))
    out = jax.jit(conv.apply)(params, blk, jnp.asarray(x))
    return arrs, es, x, np.asarray(attn), jax.tree_util.tree_map(np.asarray, params), \
        np.asarray(out)


@pytest.mark.parametrize("score", ["dot", "add"])
def test_sampled_block_attention_and_convs_match_jax(score):
    """On a localized block whose rows are the next-deeper layer's outputs:
    the attention, and GTConv (dot) or GATConv (add) with JAX's weights,
    whose output is ``[s_pad, h * f]``."""
    _, tg = _sampled_graph()
    tblocks, _ = NeighborSampler(tg).sample_localized(
        np.arange(128), [4, 4], seed=5, pad_to=[128, 640], support_pad=3200)
    blk = tblocks[0].to("cpu")
    arrs, es, x, want_attn, params, want_out = _jax_attention(score)
    t = [torch.from_numpy(a) for a in arrs]
    te = [torch.from_numpy(e) for e in es]
    if score == "dot":
        got = sampled_block_attention(blk, *t)
    else:
        got = sampled_block_attention(blk, None, None, t[2], score="add", e_row=te[0],
                                      e_col=te[1])
    assert got.shape == (128, 2, 8)
    np.testing.assert_allclose(got.numpy(), want_attn, **ATTN_TOL)
    conv = "gt" if score == "dot" else "gat"
    sd = {}
    weights._conv(sd, weights._top(params), conv, "c", conv)
    tconv = make_conv(conv, 12, 8, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    tconv.load_state_dict({k[2:]: v for k, v in sd.items()})
    out = tconv(blk, torch.from_numpy(x))
    # [s_pad, h * f]: GT splits out_size 8 over the heads, GAT concatenates them
    assert out.shape == want_out.shape == ((128, 8) if score == "dot" else (128, 16))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **ATTN_TOL)


def test_dispatch_sampled_block():
    """auto, sampled and bucket agree; other methods raise ValueError;
    dropout and return_weights raise NotImplementedError (never silently
    ignored), as in the JAX package."""
    _, tg = _sampled_graph()
    blk = NeighborSampler(tg).sample_layer(np.arange(0, 200, 2), fanout=4, seed=0).to("cpu")
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((200, 1, 4)).astype(np.float32))
               for _ in range(3))
    want = sampled_block_attention(blk, q, k, v)
    for method in ("auto", "sampled", "bucket"):
        torch.testing.assert_close(graph_attention(blk, q, k, v, method=method), want,
                                   rtol=0, atol=0)
    for method in ("reference", "dense", "flash", "dist"):
        with pytest.raises(ValueError, match="invalid for SampledBlock"):
            graph_attention(blk, q, k, v, method=method)
    with pytest.raises(NotImplementedError, match="never silently ignored"):
        graph_attention(blk, q, k, v, dropout_rate=0.5,
                        dropout_generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="return_weights"):
        graph_attention(blk, q, k, v, return_weights=True)


def _run_localized(blocks, x_sup):
    """Localized blocks chained input-first; features pass straight
    through the attention (q = k = v)."""
    h = x_sup
    for blk in reversed(blocks):
        hh = h[:, None, :]
        h = sampled_block_attention(blk, hh, hh, hh)[:, 0, :]
    return h


def test_localized_matches_global():
    """Block-local indices compute what the global-id blocks compute with
    full-size buffers between the layers (tests/test_sampled_local.py)."""
    rows, cols, _ = random_graph_coo(np.random.default_rng(9), 200, 6, zero_deg_frac=0.0)
    g = Graph.from_coo(rows, cols, 200, device="cpu")
    sampler = NeighborSampler(g)
    seeds, fanouts, pad_to = np.arange(128), [4, 4], [128, 128 * 5]
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((200, 8)).astype(np.float32))
    h = x
    for blk in reversed(sampler.sample(seeds, fanouts, seed=3, pad_to=pad_to)):
        blk = blk.to("cpu")
        out = sampled_block_attention(blk, h[:, None], h[:, None], h[:, None])[:, 0]
        buf = torch.zeros(201, 8)
        h = buf.index_copy(0, blk.seeds, out)[:200]  # padded seeds land in row 200
    want = h[torch.from_numpy(seeds)]
    blocks, sup = sampler.sample_localized(seeds, fanouts, seed=3, pad_to=pad_to,
                                           support_pad=128 * 25)
    x_pad = torch.cat([x, torch.zeros(1, 8)])
    got = _run_localized([b.to("cpu") for b in blocks], _take(x_pad, torch.from_numpy(sup)))
    torch.testing.assert_close(got[:128], want, rtol=1e-4, atol=1e-5)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


def test_localized_step_has_no_full_size_tensors():
    """Every op output in a localized step is O(batch * fanout): none has a
    leading dim of n, the full graph's size."""
    n, f, bs = 5000, 8, 64
    rows, cols, _ = random_graph_coo(np.random.default_rng(11), n, 6, zero_deg_frac=0.0)
    sampler = NeighborSampler(Graph.from_coo(rows, cols, n, device="cpu"))
    blocks, sup = sampler.sample_localized(np.arange(bs), [4, 4], seed=0,
                                           pad_to=[bs, bs * 5], support_pad=bs * 25)
    blocks = [b.to("cpu") for b in blocks]
    x_full = torch.zeros(n + 1, f)
    sup = torch.from_numpy(sup)
    with _Shapes() as rec:
        _run_localized(blocks, _take(x_full, sup))
    assert rec.shapes, "no op was recorded"
    big = [(op, s) for op, s in rec.shapes if s and s[0] >= n]
    assert not big, f"full-graph-sized intermediates in the sampled step: {big}"


def test_localized_truncation_masks_overflow():
    """Support overflow is truncated, not mis-indexed: overflowing edges are
    masked out and the outputs stay finite."""
    rows, cols, _ = random_graph_coo(np.random.default_rng(12), 300, 10, zero_deg_frac=0.0)
    sampler = NeighborSampler(Graph.from_coo(rows, cols, 300, device="cpu"))
    bs = 32
    blocks, sup = sampler.sample_localized(np.arange(bs), [8, 8], seed=1,
                                           pad_to=[bs, bs * 2], support_pad=bs * 3)
    for blk in blocks:
        b = blk.bg.buckets[0]
        assert b.nbr[b.emask].max(initial=0) < sup.shape[0] + bs * 2
    x_sup = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (sup.shape[0], 4)).astype(np.float32))
    out = _run_localized([b.to("cpu") for b in blocks], x_sup)
    assert torch.isfinite(out).all()


N, BS, HIDDEN, CLASSES, FANOUTS = 200, 128, 16, 3, [4, 4]


class _JaxSampledNet(nn.Module):
    """The JAX trainer's SampledNet (scripts/train_sampled.py)."""

    hidden: int
    n_classes: int

    @nn.compact
    def __call__(self, blocks, x_sup):
        h = nn.Dense(self.hidden)(x_sup)
        for li, blk in enumerate(reversed(blocks)):
            h = JaxGTConv(self.hidden, name=f"conv_{li}")(blk, h)
        return nn.Dense(self.n_classes)(h)


def _slice_inputs():
    rng = np.random.default_rng(14)
    x = np.concatenate([rng.standard_normal((N, HIDDEN)).astype(np.float32),
                        np.zeros((1, HIDDEN), np.float32)])
    y = rng.integers(0, CLASSES, N)
    seeds = [rng.permutation(N)[:BS] for _ in range(3)]
    return x, y, seeds


def _sample_kw():
    return dict(pad_to=[BS, BS * 5], support_pad=BS * 25)


@functools.cache
def _jax_slice():
    """Three Adam steps (lr 1e-2) of the JAX SampledNet on three sampled
    batches: the first step's logits and gradients, and the three losses."""
    jg, _ = _sampled_graph()
    sampler = jax_sampling.NeighborSampler(jg)
    x, y, seeds = _slice_inputs()
    model = _JaxSampledNet(HIDDEN, CLASSES)
    batches = [sampler.sample_localized(s, FANOUTS, seed=i, **_sample_kw())
               for i, s in enumerate(seeds)]
    take = lambda sup: jnp.take(jnp.asarray(x), jnp.asarray(sup), axis=0, mode="clip")
    params = jax.jit(lambda b, xs: model.init(jax.random.key(0), b, xs))(
        batches[0][0], take(batches[0][1]))
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, o, blocks, x_sup, yb):
        def loss_fn(pp):
            logits = model.apply(pp, blocks, x_sup)[:BS]
            return optax.softmax_cross_entropy_with_integer_labels(logits, yb).mean(), logits
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, o = opt.update(grads, o)
        return optax.apply_updates(p, up), o, loss, logits, grads

    p0 = jax.tree_util.tree_map(np.asarray, params)
    o = opt.init(params)
    losses, first = [], None
    for (blocks, sup), s in zip(batches, seeds):
        params, o, loss, logits, grads = step(params, o, blocks, take(sup), jnp.asarray(y[s]))
        losses.append(float(loss))
        if first is None:
            first = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads))
    return p0, first[0], first[1], losses


def test_sampled_net_matches_jax():
    """The slice as a whole: a tiny SampledNet with JAX's weights gives JAX's
    logits and first-step gradients, and three Adam steps JAX's losses."""
    p0, want_logits, want_grads, want_losses = _jax_slice()
    _, tg = _sampled_graph()
    sampler = NeighborSampler(tg)
    x, y, seeds = _slice_inputs()
    model = SampledNet(HIDDEN, HIDDEN, CLASSES, len(FANOUTS),
                       generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(weights.sampled_net_params_from_flax(p0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    grads_sd = weights.sampled_net_params_from_flax(want_grads)
    losses = []
    for i, s in enumerate(seeds):
        blocks, sup = sampler.sample_localized(s, FANOUTS, seed=i, **_sample_kw())
        blocks = [b.to("cpu") for b in blocks]
        opt.zero_grad()
        logits = model(blocks, _take(torch.from_numpy(x), torch.from_numpy(sup)))[:BS]
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[s]))
        loss.backward()
        if i == 0:
            np.testing.assert_allclose(logits.detach().numpy(), want_logits, **ATTN_TOL)
            for name, param in model.named_parameters():
                np.testing.assert_allclose(param.grad.numpy(), grads_sd[name].numpy(),
                                           **GRAD_TOL, err_msg=name)
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
