"""Dot-score dropout, any head dim, the shape rules of ``auto`` and padding
on the port's flash path, against the JAX package (CPU).

The port's ``_FlashDot`` runs the plain versions of kernels #1 and #3 on CPU
tensors; the JAX side runs its Pallas kernels in interpret mode or its dense
formulation.  Dropout compares the edge-hash mask bitwise: both packages get
the uint32 seed itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.ops import dense_block as jax_dense
from dfgnn_tpu.ops.edge_dropout import keep_scale as jax_keep_scale
from dfgnn_tpu.ops.edge_dropout import seed_from_key
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.data.synthetic import attention_inputs
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import conv as conv_mod
from dfgnn_tpu_torch.ops import dense_block, flash_mask, graph_attention

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)  # test_dropout_ckpt.py's gradient bar
NEG = -1e30


def _case(seed, B, h, P, f, *, with_val=False, empty_graph=False):
    """attention_inputs (padded nodes, empty rows) as numpy, optionally with
    the last graph emptied, as a JAX and a port DenseBatch, and a seeded
    output gradient."""
    q, k, v, adj, val = attention_inputs(np.random.default_rng(seed), B, h, P, f)
    if empty_graph:
        adj[-1] = 0
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    mask = np.ones((B, P), bool)
    jb = JaxDenseBatch(adj=jnp.asarray(adj.astype(bool)), node_mask=jnp.asarray(mask),
                       val=jnp.asarray(val) if with_val else None, n_graphs=B, np_pad=P)
    tb = DenseBatch(adj=torch.from_numpy(adj), node_mask=torch.from_numpy(mask),
                    val=torch.from_numpy(val) if with_val else None, n_graphs=B, np_pad=P)
    return (q, k, v, do), jb, tb


def _port(tb, q, k, v, do, seed=0, rate=0.0):
    """Output and (dq, dk, dv) through _FlashDot with the seed itself."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    val = None if tb.val is None else tb.val.float()
    out = flash_mask._FlashDot.apply(*leaves, tb.adj, val, seed, rate)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


def _jax_keep(seed, rate, B, h, P):
    """JAX's keep factor [B, h, P, P] with the Pallas kernels' ids."""
    g = jnp.arange(B)[:, None, None]
    r = g * P + jnp.arange(P)[None, :, None]
    c = g * P + jnp.arange(P)[None, None, :]
    return jnp.stack([jax_keep_scale(jnp.uint32(seed), r, c, hh, rate) for hh in range(h)],
                     axis=1)


def test_dot_dropout_matches_masked_reference():
    """The forward and the backward with dropout against the dense JAX
    formulation that applies the same keep_scale mask to the normalised
    weights, as tests/test_dropout_ckpt.py holds JAX's own flash kernel."""
    B, h, P, f, rate, seed = 4, 2, 32, 8, 0.4, 0x9E3779B9
    (q, k, v, do), jb, tb = _case(3, B, h, P, f)
    ks = _jax_keep(seed, rate, B, h, P)

    @jax.jit
    def ref_vjp(q, k, v, do):
        def ref(q, k, v):
            s = jnp.einsum("brhf,bchf->bhrc", q, k, precision="highest")
            s = jnp.where(jb.adj[:, None], s, NEG)
            m = jnp.max(s, axis=-1, keepdims=True)
            ex = jnp.where(jb.adj[:, None], jnp.exp(s - jnp.maximum(m, NEG)), 0.0)
            den = jnp.sum(ex, axis=-1, keepdims=True)
            w = jnp.where(den > 0, ex / jnp.where(den > 0, den, 1.0), 0.0)
            return jnp.einsum("bhrc,bchf->brhf", w * ks, v, precision="highest")
        out, vjp = jax.vjp(ref, q, k, v)
        return out, vjp(do)

    want_out, want = ref_vjp(*map(jnp.asarray, (q, k, v, do)))
    out, got = _port(tb, q, k, v, do, seed, rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # the mask dropped edges and kept others
    kept = np.asarray(ks)[np.broadcast_to(np.asarray(jb.adj)[:, None], ks.shape)]
    assert 0 < (kept == 0).mean() < 1


def test_dot_dropout_matches_jax_pallas_interpret():
    """graph_attention(score="dot", dropout_rate>0) on a DenseBatch against
    JAX's flash kernels (interpret mode) with the same key: the port takes
    the key's uint32 seed, so outputs and gradients agree at the fp32 bar."""
    B, h, P, f, rate = 2, 2, 16, 8, 0.3
    (q, k, v, do), jb, tb = _case(4, B, h, P, f, with_val=True)
    key = jax.random.key(11)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_graph_attention(jb, a, b, c, dropout_rate=rate,
                                                        dropout_rng=key, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    out, got = _port(tb, q, k, v, do, int(seed_from_key(key)), rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_dot_dropout_through_graph_attention_draws_the_generator_seed():
    """The public path: graph_attention with a CPU generator draws the seed
    that dropout_factor keys, on the normalised weights."""
    (q, k, v, _), _, tb = _case(5, 2, 1, 16, 8)
    gen = torch.Generator().manual_seed(7)
    seed = flash_mask.edge_dropout.seed_from_generator(torch.Generator().manual_seed(7))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = graph_attention(tb, qt, kt, vt, dropout_rate=0.25, dropout_generator=gen)
    w = dense_block.dense_graph_attention(tb, qt, kt, vt, return_weights=True)[1]
    keep = flash_mask.dropout_factor(seed, 0.25, 2, 1, 16, "cpu")
    torch.testing.assert_close(got, torch.einsum("bhrc,bchf->brhf", w * keep, vt), **FWD_TOL)
    with pytest.raises(ValueError, match="dropout_generator"):
        graph_attention(tb, qt, kt, vt, dropout_rate=0.25)


def test_dot_dropout_mask_is_bitwise_jax_keep_scale():
    B, h, P, rate, seed = 3, 2, 24, 0.4, 123456789
    got = flash_mask.dropout_factor(seed, rate, B, h, P, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_keep(seed, rate, B, h, P)))


@pytest.mark.parametrize("f", [12, 48])
def test_any_head_dim_matches_jax_dense(f):
    """method="flash" at head dims outside 8..256 in powers of two (kernels
    #1 and #3 take any f up to 256) against JAX's dense formulation, forward
    and gradients."""
    B, h, P = 2, 2, 24
    (q, k, v, do), jb, tb = _case(6, B, h, P, f)

    @jax.jit
    def ref_vjp(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: jax_dense.dense_graph_attention(jb, a, b, c),
                           q, k, v)
        return out, vjp(do)

    with jax.default_matmul_precision("highest"):
        want_out, want = ref_vjp(*map(jnp.asarray, (q, k, v, do)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = graph_attention(tb, *leaves, method="flash")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _batch(n_graphs, P, val=False):
    adj = torch.ones(n_graphs, P, P, dtype=torch.uint8)
    return DenseBatch(adj=adj, node_mask=torch.ones(n_graphs, P, dtype=torch.bool),
                      val=adj.float() if val else None, n_graphs=n_graphs, np_pad=P)


@pytest.mark.parametrize("conv,P,width,want", [
    ("gt", 512, 128, "flash_fused"),  # #5 streams its key tiles: any P up to 2048
    ("gt", 128, 128, "flash_fused"),
    # #6 takes every shape here; past P = GAT_FUSED_MAX_P the flash route wins
    ("gat", 512, 256, "flash"),
    ("gat", 640, 128, "flash"),
    ("gat", 512, 128, "flash"),
    ("gat", 128, 48, "flash_fused"),  # #6 takes any f up to 256
])
def test_bf16_auto_routes_on_the_whole_layer_kernels_shared_memory(conv, P, width, want):
    """The bf16 auto rules route to the whole-layer kernels only where they
    take the shape; GAT's past P = 128 only up to its measured bound
    GAT_FUSED_MAX_P."""
    batch = _batch(8, P)  # few tokens: GT's rule would pick flash_fused
    if conv == "gt":
        assert conv_mod._auto_bf16_dense_batch("gt", batch, width) == want
    else:
        assert conv_mod._auto_bf16_gat(batch, width) == want
        assert (want == "flash_fused") == (P <= conv_mod.GAT_FUSED_MAX_P)
    assert flash_mask.layer_fits("dot" if conv == "gt" else "add", P, width)


def test_whole_layer_kernels_take_one_set():
    """#6 takes what #5 takes, in fp32 and bf16: any f >= 1 and any P >= 1
    (past P = 2048 the kernels walk their keys in windows).  Its argument
    check takes f = 48 at P = 640 and f = 257 and 300 (past 256, in column
    chunks on the card) at every P, past 2048 too, and refuses only an empty
    head dim."""
    for P in (1, 24, 128, 129, 640, 2048, 2049, 4096):
        for f in (1, 12, 48, 75, 128, 256, 257, 300):
            assert flash_mask.layer_fits("add", P, f) == flash_mask.layer_fits("dot", P, f)
            assert flash_mask.layer_fits("add", P, f)
    assert not flash_mask.layer_fits("add", 16, 0) and not flash_mask.layer_fits("dot", 0, 8)

    def check(P, f, dtype=torch.float32):
        flash_mask._check_layer_args(
            "add", torch.zeros(1, P, 8, dtype=dtype), torch.zeros(1, P, P, dtype=torch.uint8),
            (torch.zeros(1, 8, f, dtype=dtype),), [torch.zeros(1, f)] * 3)

    check(640, 48)
    check(640, 48, torch.bfloat16)
    for P in (1, 128, 129, 2048, 2049):
        for f in (257, 300):
            check(P, f)
    check(300, 257, torch.bfloat16)
    for f in (48, 300):
        check(2049, f)
        check(2049, f, torch.bfloat16)
    with pytest.raises(ValueError, match="f >= 1"):
        check(2049, 0)


def test_auto_routes_head_dims_the_kernels_do_not_take_to_dense(monkeypatch):
    """method="auto" on a DenseBatch: the flash kernels wherever they take
    the shape, which is every head dim (past 256 in chunks) and every P
    (past 2048 in windows of keys), as JAX's auto always takes Pallas; an
    explicit "flash" stays."""
    calls = []
    monkeypatch.setattr(flash_mask, "flash_graph_attention",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(dense_block, "dense_graph_attention",
                        lambda *a, **kw: calls.append("dense"))
    monkeypatch.delenv("DFGNN_TPU_FORCE_METHOD", raising=False)
    for score, P, f, want in [("dot", 16, 12, "flash"), ("dot", 16, 256, "flash"),
                              ("dot", 16, 300, "flash"), ("dot", 16, 1024, "flash"),
                              ("add", 16, 16, "flash"), ("add", 16, 12, "flash"),
                              ("add", 16, 48, "flash"), ("add", 16, 300, "flash"),
                              ("dot", 2049, 8, "flash"), ("add", 2049, 8, "flash")]:
        calls.clear()
        batch, e, v = _batch(1, P), torch.zeros(1, P, 1), torch.zeros(1, P, 1, f)
        kw = dict(score="add", e_row=e, e_col=e) if score == "add" else {}
        graph_attention(batch, v, v, v, **kw)
        graph_attention(batch, v, v, v, method="flash", **kw)
        assert calls == [want, "flash"], (score, P, f)


def test_explicit_flash_refuses_head_dims_the_kernels_do_not_take():
    """What the wrappers check before a launch: the kernels of either score
    take any head dim (f = 48, 300, 1024) and any P (2049 too); only an
    empty head dim or node axis is refused, and flash_takes agrees."""
    adj = torch.ones(2, 16, 16, dtype=torch.uint8)
    for f in (48, 300, 1024):
        for score in ("dot", "add"):
            flash_mask._check_block_args(torch.zeros(2, 16, 1, f), adj, None, score=score)
            assert flash_mask.flash_takes(score, 16, f)
    adj2049 = torch.ones(1, 2049, 2049, dtype=torch.uint8)
    for score in ("dot", "add"):
        flash_mask._check_block_args(torch.zeros(1, 2049, 1, 8), adj2049, None, score=score)
        assert flash_mask.flash_takes(score, 2049, 8)
        with pytest.raises(ValueError, match="f >= 1"):
            flash_mask._check_block_args(torch.zeros(2, 16, 1, 0), adj, None, score=score)
        assert not flash_mask.flash_takes(score, 16, 0)


def test_empty_rows_and_graphs_give_zero_outputs_and_gradients():
    """Rows without an edge and a graph without any: out = 0, lse = -1e30
    and zero gradients, as the Pallas kernels give them (JAX's lse beside)."""
    B, h, P, f = 3, 2, 16, 8
    (q, k, v, do), jb, tb = _case(8, B, h, P, f, empty_graph=True)
    hm = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, want_lse = jax_flash._fwd(jb.adj.astype(jnp.uint8), hm(q), hm(k), hm(v), None, None,
                                 "dot", 0.2, True, jax.lax.Precision.HIGHEST, want_lse=True)
    out, lse = flash_mask.flash_mask_fwd(*map(torch.from_numpy, (q, k, v)), tb.adj,
                                         want_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
    empty = tb.adj.sum(-1) == 0                      # [B, P]
    assert empty[-1].all() and empty[:-1].any()
    assert (lse.permute(1, 2, 0)[empty] == NEG).all()
    assert (out[empty] == 0).all()
    _, (dq, dk, dv) = _port(tb, q, k, v, do)
    assert (dq[empty] == 0).all()
    no_in_edge = tb.adj.sum(-2) == 0                 # keys no row attends to
    assert (dk[no_in_edge] == 0).all() and (dv[no_in_edge] == 0).all()
    assert (dq[-1] == 0).all() and (dk[-1] == 0).all() and (dv[-1] == 0).all()
