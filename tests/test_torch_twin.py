"""The training path end to end, on the CPU: one GTModel training step of
the port against the JAX package's, with the JAX weights carried across by
dfgnn_tpu_torch.weights (collation, model, flash backward, loss, Adam); and
the trainer twin ``dfgnn_tpu_torch.scripts.train_gtconv`` with the CLI it
reads."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfgnn_tpu.data import collate as jax_collate
from dfgnn_tpu.data import datasets as jax_datasets
from dfgnn_tpu.models import GTModel as JaxGTModel
from dfgnn_tpu.train import loop as jax_loop
from dfgnn_tpu.utils import config as jax_config
from dfgnn_tpu_torch.data.collate import collate_dense
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.models import GTModel
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.scripts import train_gtconv
from dfgnn_tpu_torch.train import loop
from dfgnn_tpu_torch.utils import config
from dfgnn_tpu_torch.weights import gtmodel_params_from_flax

MODEL_TOL = dict(rtol=1e-3, atol=1e-5)  # the repo's bar


def _molhiv_batches(n_batches, B=8, P=32):
    """Identical collated ogbg-molhiv batches for both packages, of graphs
    with at most P nodes (small [B, P, P] blocks keep JAX's compile short)."""
    jds = jax_datasets.load_batched("ogbg-molhiv", n_graphs=64, quiet=True)
    tds = load_batched("ogbg-molhiv", n_graphs=64, quiet=True)
    fit = np.array([i for i, g in enumerate(tds.graphs) if g[2] <= P])
    out = []
    for i in range(n_batches):
        idx = fit[i * B:(i + 1) * B]
        jb, jx, jy, jm = jax_collate.collate_dense(jds, idx, np_pad=P)
        jb = jb.replace(adj=jnp.asarray(jb.adj), node_mask=jnp.asarray(jb.node_mask))
        out.append(((jb, *map(jnp.asarray, (jx, jy, jm))),
                    collate_dense(tds, idx, np_pad=P, device="cpu")))
    return tds, out


def test_gtmodel_train_step_matches_jax():
    """Three Adam steps of each package's GTModel from the same weights on the
    same batches.  After the first, the loss and every parameter's gradient
    agree; after each, the loss.  The port runs its default path (the flash
    Function, plain versions on the CPU); JAX runs its plain reference, the
    dense path, compiled once (its Pallas backward is held against the
    port's in tests/test_torch_flash_bwd.py)."""
    ds, batches = _molhiv_batches(3)
    (jb, jx, jy, jm), tbatch = batches[0]
    jmodel = JaxGTModel("ogbg-molhiv", out_size=1, hidden_size=16, num_layers=2,
                        method="dense")
    params = jax.jit(jmodel.init)(jax.random.key(0), jb, jx)
    jstate = jax_loop.TrainState.create(jmodel, params, lr=1e-3, step_lr_every=20)
    jloss = jax_loop.make_loss_fn(jmodel, ds.task, ds.num_classes)

    @jax.jit
    def jstep(params, opt_state, *batch):  # jax_loop.train_step, with its gradients
        loss, grads = jax.value_and_grad(jloss)(params, *batch)
        updates, opt_state = jstate.opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    model = GTModel("ogbg-molhiv", out_size=1, hidden_size=16, num_layers=2,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(gtmodel_params_from_flax(params))
    state = loop.TrainState.create(model, lr=1e-3, step_lr_every=20, device="cpu")
    tloss = loop.make_loss_fn(model, ds.task, ds.num_classes)
    jparams, jopt = jstate.params, jstate.opt_state
    flash_mask.LAUNCHES = flash_mask.BWD_LAUNCHES = 0
    for n, (jbatch, tb) in enumerate(batches):
        jparams, jopt, want_loss, want_grads = jstep(jparams, jopt, *jbatch)
        state, loss = loop.train_step(state, tloss, *tb)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3)
        if n == 0:
            want = gtmodel_params_from_flax(jax.tree_util.tree_map(np.asarray, want_grads))
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **MODEL_TOL,
                                           err_msg=name)
    assert (flash_mask.LAUNCHES, flash_mask.BWD_LAUNCHES) == (0, 0)


SMALL = ["--dataset", "ogbg-molhiv", "--dim", "16", "--batch-size", "8", "--n-layers", "2",
         "--device", "cpu"]


def test_checkgrad_is_ok_on_the_cpu(capsys):
    assert train_gtconv.main(SMALL + ["--epochs", "1", "--checkgrad"]) == {"checkgrad": "OK"}
    out = capsys.readouterr().out
    assert "checkgrad: OK" in out.splitlines()
    assert "impl='reference'" in out  # it names its oracle, the JAX script's


def test_trains_an_epoch_on_the_cpu(capsys):
    history = train_gtconv.main(SMALL + ["--epochs", "1"])
    steps = history["steps"]
    assert len(steps) == 8  # 64 graphs in batches of 8
    assert all(math.isfinite(s["loss"]) for s in steps)
    assert all((s["fwd_launches"], s["bwd_launches"]) == (0, 0) for s in steps)  # CPU
    (line,) = [l for l in capsys.readouterr().out.splitlines() if l.startswith("epoch 0:")]
    assert "loss=" in line and "metric=" in line


def test_node_level_dataset_fails_as_in_the_jax_script():
    """PATTERN's labels are per node, GTModel's output per graph: the JAX
    script fails the same way (a divergence of the reference, kept)."""
    with pytest.raises((ValueError, RuntimeError)):
        train_gtconv.main(["--dataset", "PATTERN", "--dim", "8", "--batch-size", "2",
                           "--n-layers", "1", "--epochs", "1", "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    [],
    ["--dim", "32", "--epochs", "2"],
    ["--dim=64", "--n-layers", "3"],
])
def test_parse_args_merges_yaml_like_jax(tmp_path, argv):
    cfg = tmp_path / "run.yaml"
    cfg.write_text("dim: 256\nepochs: 5\nn-layers: 4\nlr: 0.01\nformat: csr\nunknown: 1\n")
    argv = ["--config", str(cfg), *argv]
    got = config.parse_args(config.build_parser(), argv)
    want = jax_config.parse_args(jax_config.build_parser(), argv)
    assert vars(got) == vars(want)


def test_format_aliases_match_jax():
    assert config.FORMAT_ALIASES == jax_config.FORMAT_ALIASES
    assert config.resolve_format("hyper") == "flash"
    with pytest.raises(KeyError):
        config.resolve_format("nope")
