"""The port's full-graph bucket path against the JAX package's (CPU).

The JAX bucket path runs under ``jax.jit``, twice in this file: once for
its forwards (dot and add over the flat, segment, tiled, blocked and
edge-value layouts, and with dropout) and once for its custom VJPs (flat and
blocked transposed layouts, with and without dropout).  Everything else is
held against JAX's segment-op oracle.  With dropout, JAX is handed the
uint32 seed that the port draws from its generator, so the two masks are
the same hash bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu import formats as jax_formats
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu.ops import bucket as jax_bucket
from dfgnn_tpu.ops import reference as jax_ref
from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.ops import bucket, edge_dropout, graph_attention
from helpers import random_graph_coo

TOL = dict(rtol=1e-4, atol=1e-5)
N, H, F = 300, 2, 16
GEN_SEED, RATE = 7, 0.4
SEED = edge_dropout.seed_from_generator(torch.Generator().manual_seed(GEN_SEED))

# name: (build_buckets keywords, tile_width, with edge values)
LAYOUTS = {
    "flat": ({}, 2048, False),                                  # buckets and segments
    "tiled": ({"split_width": None}, 32, False),                # the online-softmax scan
    "blocked": ({"src_block_rows": 128}, 2048, False),          # three source blocks
    "val": ({}, 2048, True),                                    # edge values
    "flatT": ({"with_transpose": True}, 2048, False),
    "blockedT": ({"src_block_rows": 128, "with_transpose": True}, 2048, False),
    "tiledT": ({"split_width": None, "with_transpose": True}, 32, False),
}
FWD_CASES = [(s, lay, 0.0) for lay in ("flat", "tiled", "blocked", "val") for s in ("dot", "add")]
FWD_CASES += [("add", "flat", RATE), ("dot", "blocked", RATE)]
VJP_CASES = [("dot", "flatT", 0.0), ("add", "flatT", RATE), ("dot", "blockedT", RATE),
             ("add", "blockedT", 0.0)]


@functools.cache
def _case():
    """The graph (zero-degree rows, a degree-200 super node, rows past the
    split of 64), its edge values, and the inputs, from one numpy seed."""
    rng = np.random.default_rng(0)
    rows, cols, val = random_graph_coo(rng, N, 6, super_node_deg=200, with_val=True)
    hub = np.repeat([N // 2, N - 1], [90, 70])
    rows = np.concatenate([rows, hub])
    cols = np.concatenate([cols, rng.integers(0, N, hub.size)])
    val = np.concatenate([val, rng.standard_normal(hub.size).astype(np.float32)])
    arrays = {name: rng.standard_normal((N, H, F)).astype(np.float32)
              for name in ("q", "k", "v", "do")}
    arrays.update({name: rng.standard_normal((N, H)).astype(np.float32)
                   for name in ("er", "ec")})
    return rows, cols, val, arrays


def _graphs(with_val):
    rows, cols, val, _ = _case()
    val = val if with_val else None
    return (JaxGraph.from_coo(rows, cols, N, val=val),
            Graph.from_coo(rows, cols, N, val=val, device="cpu"))


def _layouts(name):
    kw, tile, with_val = LAYOUTS[name]
    jg, tg = _graphs(with_val)
    return jax_formats.build_buckets(jg, **kw), formats.build_buckets(tg, **kw), tile


def _port_inputs(score):
    a = _case()[3]
    t = lambda name: torch.from_numpy(a[name]).requires_grad_(True)
    if score == "dot":
        return (t("q"), t("k"), t("v")), {}
    er, ec, v = t("er"), t("ec"), t("v")
    return (er, ec, v), dict(e_row=er, e_col=ec)


def _port_forward(score, layout, rate, tile, **kw):
    args, add_kw = _port_inputs(score)
    q, k = (None, None) if score == "add" else args[:2]
    out = bucket.bucket_graph_attention(
        layout, q, k, args[2], score=score, tile_width=tile, dropout_rate=rate,
        dropout_generator=torch.Generator().manual_seed(GEN_SEED), **add_kw, **kw)
    return out, args


def _jax_args(score):
    a = {k: jnp.asarray(x) for k, x in _case()[3].items()}
    return (a["q"], a["k"]) if score == "dot" else (a["er"], a["ec"])


@functools.cache
def _jax_forwards():
    """JAX's bucket forwards for FWD_CASES, in one jit."""
    layouts = {name: _layouts(name) for name in ("flat", "tiled", "blocked", "val")}
    v = jnp.asarray(_case()[3]["v"])

    def run(bgs):
        outs = []
        for score, name, rate in FWD_CASES:
            a, b = _jax_args(score)
            drop = None if rate == 0.0 else jax_bucket._drop_ctx(jnp.uint32(SEED), rate)
            dot = score == "dot"
            outs.append(jax_bucket._any_forward(
                bgs[name], a if dot else None, b if dot else None, v, score,
                None if dot else a, None if dot else b, 0.2, layouts[name][2], None,
                drop=drop)[0])
        return outs

    outs = jax.jit(run)({name: lay[0] for name, lay in layouts.items()})
    return {case: np.asarray(o) for case, o in zip(FWD_CASES, outs)}


@functools.cache
def _jax_vjps():
    """JAX's custom VJP (``_bucket_fused``) for VJP_CASES, in one jit:
    (out, grads) per case."""
    bgs = {name: _layouts(name)[0] for name in ("flatT", "blockedT")}
    v, do = (jnp.asarray(_case()[3][name]) for name in ("v", "do"))

    def run(bgs):
        res = []
        for score, name, rate in VJP_CASES:
            meta = (score, 0.2, 2048, rate, True)
            fn = lambda a, b, vv: jax_bucket._bucket_fused(meta, bgs[name], jnp.uint32(SEED),
                                                           a, b, vv)
            out, vjp = jax.vjp(fn, *_jax_args(score), v)
            res.append((out, vjp(do)))
        return res

    res = jax.jit(run)(bgs)
    return {case: (np.asarray(o), [np.asarray(x) for x in g])
            for case, (o, g) in zip(VJP_CASES, res)}


@pytest.mark.parametrize("score,layout,rate", FWD_CASES)
def test_forward_matches_jax_bucket(score, layout, rate):
    _, bg, tile = _layouts(layout)
    out, _ = _port_forward(score, bg, rate, tile)
    np.testing.assert_allclose(out.detach().numpy(), _jax_forwards()[(score, layout, rate)],
                               **TOL)


@pytest.mark.parametrize("score,layout,rate", VJP_CASES)
def test_custom_backward_matches_jax_vjp(score, layout, rate):
    """The autograd.Function's forward and its CSR / CSC backward, with the
    dropout mask regenerated from the seed."""
    _, bg, tile = _layouts(layout)
    out, args = _port_forward(score, bg, rate, tile)
    assert type(out.grad_fn).__name__ == "_BucketFusedBackward"
    grads = torch.autograd.grad(out, args, torch.from_numpy(_case()[3]["do"]))
    want_out, want_grads = _jax_vjps()[(score, layout, rate)]
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, g, w in zip(("a", "b", "v"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def _jax_oracle(score, with_val, want_grads=True):
    """JAX's segment-op oracle: (out, weights, grads of (a, b, v) against do)."""
    jg, _ = _graphs(with_val)
    a = {k: jnp.asarray(x) for k, x in _case()[3].items()}

    def fn(x, y, v):
        if score == "dot":
            return jax_ref.graph_attention_reference(jg, x, y, v, return_weights=True)
        return jax_ref.graph_attention_reference(jg, None, None, v, score="add", e_row=x,
                                                 e_col=y, return_weights=True)

    (out, w), vjp = jax.vjp(fn, *_jax_args(score), a["v"])
    grads = vjp((a["do"], jnp.zeros_like(w))) if want_grads else None
    return np.asarray(out), np.asarray(w), grads


@pytest.mark.parametrize("score", ["dot", "add"])
def test_autograd_through_the_forward_matches_jax_oracle(score):
    """Without a transpose (and with edge values) autograd runs through the
    bucket forward's torch ops."""
    for layout in ("flat", "val"):
        _, bg, tile = _layouts(layout)
        out, args = _port_forward(score, bg, 0.0, tile)
        assert type(out.grad_fn).__name__ != "_BucketFusedBackward"
        grads = torch.autograd.grad(out, args, torch.from_numpy(_case()[3]["do"]))
        want_out, _, want_grads = _jax_oracle(score, layout == "val")
        np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("score", ["dot", "add"])
def test_dropout_agrees_across_layouts(score):
    """The same seed gives the same mask bits in the flat (buckets and
    segments), tiled and blocked walks, forward and custom backward."""
    do = torch.from_numpy(_case()[3]["do"])
    results = []
    for layout in ("flatT", "tiledT", "blockedT"):
        _, bg, tile = _layouts(layout)
        out, args = _port_forward(score, bg, RATE, tile)
        results.append((out.detach(), torch.autograd.grad(out, args, do)))
    (out0, g0), *rest = results
    no_drop, _ = _port_forward(score, _layouts("flatT")[1], 0.0, 2048)
    assert not torch.allclose(out0, no_drop.detach(), **TOL)  # the mask did something
    for out, grads in rest:
        torch.testing.assert_close(out, out0, rtol=1e-5, atol=1e-6)
        for g, w in zip(grads, g0):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_dropout_id_maps_match_jax():
    """``_keep_scale_chw`` and its transpose with every id map of the dropout
    context (block rebase, row base, table map, node permutation, row map)
    give JAX's mask bits."""
    rng = np.random.default_rng(9)
    dst = rng.integers(0, 40, 6)
    src = rng.integers(0, 40, (6, 10))
    src_map = rng.permutation(64)
    id_perm = rng.permutation(65)
    row_map = rng.integers(0, 500, 41)
    for kw in ({}, {"col_base": 5}, {"row_base": 7, "id_perm": id_perm},
               {"col_base": 3, "src_map": src_map, "id_perm": id_perm}, {"row_map": row_map}):
        jkw = {k: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for k, x in kw.items()}
        tkw = {k: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
               for k, x in kw.items()}
        jdrop = jax_bucket._drop_ctx(jnp.uint32(SEED), RATE, **jkw)
        tdrop = bucket._Drop(SEED, RATE, **tkw)
        for fn in ("_keep_scale_chw", "_keep_scale_chw_T"):
            want = np.asarray(getattr(jax_bucket, fn)(jdrop, jnp.asarray(dst), jnp.asarray(src),
                                                      H))
            got = getattr(bucket, fn)(tdrop, torch.from_numpy(dst), torch.from_numpy(src), H)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32),
                                          err_msg=f"{fn} {sorted(kw)}")


@pytest.mark.parametrize("score", ["dot", "add"])
def test_return_weights_match_jax_oracle(score):
    """The normalised weights in CSR edge order, from the flat and the blocked
    edge-id layouts."""
    want_out, want_w, _ = _jax_oracle(score, False, want_grads=False)
    _, tg = _graphs(False)
    for kw in ({}, {"src_block_rows": 128}):
        bg = formats.preprocess("two_phase", tg, **kw)
        (out, w), _ = _port_forward(score, bg, 0.0, 2048, return_weights=True)
        np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
        np.testing.assert_allclose(w.detach().numpy(), want_w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("score", ["dot", "add"])
def test_bf16_gather_within_the_bar(score):
    """``gather_dtype=torch.bfloat16`` rounds the gathered table only: fp32
    output within 5e-2 of the oracle (max |diff| / max |ref|, JAX's bar)."""
    want, _, _ = _jax_oracle(score, False, want_grads=False)
    for layout in ("flat", "blocked"):
        _, bg, tile = _layouts(layout)
        out, _ = _port_forward(score, bg, 0.0, tile, gather_dtype=torch.bfloat16)
        assert out.dtype == torch.float32
        rel = np.abs(out.detach().numpy() - want).max() / np.abs(want).max()
        assert 0.0 < rel < 5e-2, rel


def test_chunk_budget_and_packing_change_no_number(monkeypatch):
    """A row never spans a chunk, so a 4 KB budget (chunks of 8 rows) gives
    the outputs and custom-backward gradients of the default one; the split
    (unpacked) tables give them too."""
    do = torch.from_numpy(_case()[3]["do"])
    _, bg, _ = _layouts("flatT")

    def run(**kw):
        out, args = _port_forward("dot", bg, RATE, 2048, **kw)
        return [out.detach(), *torch.autograd.grad(out, args, do)]

    want = run()
    monkeypatch.setattr(bucket, "_GATHER_BUDGET_BYTES", 4096)
    for got in (run(), run(packed=False)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_dispatch_and_refusals():
    _, bg, _ = _layouts("flat")
    args, _ = _port_inputs("dot")
    want = bucket.bucket_graph_attention(bg, *args)
    for method in ("auto", "bucket"):
        torch.testing.assert_close(graph_attention(bg, *args, method=method), want)
    with pytest.raises(ValueError, match="invalid for BucketedGraph"):
        graph_attention(bg, *args, method="flash")
    with pytest.raises(ValueError, match="dropout_generator"):
        bucket.bucket_graph_attention(bg, *args, dropout_rate=0.1)
    with pytest.raises(ValueError, match="edge-id layout"):
        bucket.bucket_graph_attention(bg, *args, return_weights=True)
    _, tg = _graphs(False)
    tiled = formats.build_buckets(tg, split_width=None, with_edge_ids=True)
    with pytest.raises(NotImplementedError, match="split_width"):
        bucket.bucket_graph_attention(tiled, *args, tile_width=32, return_weights=True)
