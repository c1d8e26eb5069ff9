"""The port's GTConv and GTModel against the JAX package's, with the JAX
weights carried across by dfgnn_tpu_torch.weights (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.models import GTModel as JaxGTModel
from dfgnn_tpu.models import make_conv
from dfgnn_tpu_torch.data.synthetic import pattern_like_batch
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import GTConv, GTModel, graph_pool
from dfgnn_tpu_torch.models.model import _ATOM_FEATURE_DIMS
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.weights import gtmodel_params_from_flax
from helpers import random_graph_coo

MODEL_TOL = dict(rtol=1e-3, atol=1e-5)  # the repo's bar


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batches(rng, B, P):
    graphs = []
    for _ in range(B):
        nb = int(rng.integers(P // 2, P))
        r, c, _ = random_graph_coo(rng, nb, 6, zero_deg_frac=0.1)
        graphs.append((r, c, nb))
    return (JaxDenseBatch.from_graph_list(graphs, np_pad=P),
            DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu"))


def _node_features(rng, dataset, n):
    if dataset == "PATTERN":
        return rng.integers(0, 3, size=(n,))
    if dataset == "MNIST":
        return rng.standard_normal((n, 3)).astype(np.float32)
    # atom ids, some out of every vocabulary: both packages clip them
    return rng.integers(0, 130, size=(n, len(_ATOM_FEATURE_DIMS)))


def _jax_and_torch_model(jb, x, dataset, hidden, layers, heads=1, method="auto"):
    jm = JaxGTModel(dataset, out_size=3, hidden_size=hidden, num_layers=layers,
                    num_heads=heads, method=method)
    params = jm.init(jax.random.key(0), jb, jnp.asarray(x))
    tm = GTModel(dataset, out_size=3, hidden_size=hidden, num_layers=layers,
                 num_heads=heads, in_size=x.shape[-1] if x.ndim == 2 else None,
                 generator=_gen(), device="cpu")
    tm.load_state_dict(gtmodel_params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("dataset", ["PATTERN", "MNIST", "ogbg-molhiv"])
def test_converter_uses_every_leaf_and_fills_every_parameter(rng, dataset):
    jb, _ = _batches(rng, 2, 16)
    x = _node_features(rng, dataset, 2 * 16)
    _, params, tm = _jax_and_torch_model(jb, x, dataset, hidden=8, layers=2,
                                         method="dense")
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    torch_params = dict(tm.named_parameters())
    assert len(flat) == len(torch_params)  # every leaf became one parameter
    names = {"Embed_0": "inproj", "Dense_0": "inproj", "AtomEncoder_0": "inproj"}
    for path, leaf in flat:
        keys = [p.key for p in path]
        head = names.get(keys[0], keys[0].replace("layer_", "layers."))
        name = ".".join([head, *keys[1:-1]])
        if keys[-1] == "kernel":
            got = torch_params[f"{name}.weight"].T
        elif keys[-1] == "embedding":
            got = torch_params[f"{name}.weight"]
        else:
            got = torch_params[f"{name}.bias"]
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(leaf))


@pytest.mark.parametrize("break_it", ["extra_leaf", "missing_leaf", "layer_gap"])
def test_converter_raises_on_a_tree_it_cannot_fill(rng, break_it):
    jb, _ = _batches(rng, 2, 16)
    _, params, _ = _jax_and_torch_model(jb, _node_features(rng, "PATTERN", 32),
                                        "PATTERN", hidden=8, layers=2, method="dense")
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    tree = {k: dict(v) for k, v in tree.items()}
    if break_it == "extra_leaf":
        tree["layer_1"]["o_proj"] = tree["layer_1"]["q_proj"]
    elif break_it == "missing_leaf":
        tree["layer_0"]["k_proj"] = {"kernel": tree["layer_0"]["k_proj"]["kernel"]}
    else:
        tree["layer_2"] = tree.pop("layer_1")
    with pytest.raises(KeyError):
        gtmodel_params_from_flax(tree)


def test_gtconv_matches_jax(rng):
    jb, tb = _batches(rng, 3, 64)
    x = rng.standard_normal((3 * 64, 24)).astype(np.float32)
    layer = make_conv("gt", out_size=32, num_heads=2)
    params = layer.init(jax.random.key(1), jb, jnp.asarray(x))["params"]
    conv = GTConv(24, 32, num_heads=2, generator=_gen(), device="cpu")
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj"):
            getattr(conv, name).weight.copy_(torch.from_numpy(np.array(params[name]["kernel"]).T))
            getattr(conv, name).bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
    want = layer.apply({"params": params}, jb, jnp.asarray(x))  # the Pallas flash path
    got = conv(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("dataset", ["PATTERN", "MNIST", "ogbg-molhiv"])
def test_gtmodel_matches_jax_flash_path(rng, dataset):
    """JAX's default fp32 path (the Pallas flash kernel, interpreted) against
    the port's default path (the kernel's plain version on the CPU)."""
    jb, tb = _batches(rng, 4, 64)
    x = _node_features(rng, dataset, 4 * 64)
    jm, params, tm = _jax_and_torch_model(jb, x, dataset, hidden=16, layers=2)
    want = jm.apply(params, jb, jnp.asarray(x))
    flash_mask.LAUNCHES = 0
    got = tm(tb, torch.from_numpy(x))
    assert flash_mask.LAUNCHES == 0  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)


def test_gtmodel_full_width_matches_jax_dense():
    """The serving model's full width (hidden 128, 8 layers) on a small
    PATTERN-like batch, against JAX's dense path (no interpret time)."""
    rng = np.random.default_rng(0)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 2)]
    jb = JaxDenseBatch.from_graph_list(graphs, np_pad=128)
    tb = DenseBatch.from_graph_list(graphs, np_pad=128, device="cpu")
    x = rng.integers(0, 3, size=(2 * 128,))
    jm, params, tm = _jax_and_torch_model(jb, x, "PATTERN", hidden=128, layers=8,
                                          method="dense")
    want = jm.apply(params, jb, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(tb, torch.from_numpy(x))
    assert np.isfinite(got.numpy()).all() and got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_init_is_seeded_and_lecun_scaled():
    a = GTModel("PATTERN", out_size=2, hidden_size=64, num_layers=2, generator=_gen(3),
                device="cpu")
    b = GTModel("PATTERN", out_size=2, hidden_size=64, num_layers=2, generator=_gen(3),
                device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    w = a.layers[0].q_proj.weight.detach()
    assert abs(float(w.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5  # variance 1 / fan_in
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / 0.87962566103423978
    assert not a.layers[0].q_proj.bias.any()
    assert abs(float(a.inproj.weight.detach().std()) - 64 ** -0.5) < 0.25 * 64 ** -0.5


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_graph_pool_ignores_padding(rng, op):
    _, tb = _batches(rng, 3, 16)
    x = torch.from_numpy(rng.standard_normal((3 * 16, 5)).astype(np.float32))
    got = graph_pool(tb, x, op)
    xb, mask = x.reshape(3, 16, 5), tb.node_mask
    want = torch.stack([xb[b][mask[b]].sum(0) if op == "sum" else xb[b][mask[b]].mean(0)
                        for b in range(3)])
    torch.testing.assert_close(got, want)
