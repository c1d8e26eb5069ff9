"""The port's training loop against the JAX package's (CPU): the task
losses, and Adam / AdamW with the staircase schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.train import loop as jax_loop
from dfgnn_tpu_torch.train import loop


class _FixedLogits:
    """A flax-like model whose output is given."""

    def __init__(self, logits):
        self.logits = logits

    def apply(self, params, g, x):
        return jnp.asarray(self.logits)


def _task_inputs(rng, task, C, n, empty_mask=False):
    logits = rng.standard_normal((n, C)).astype(np.float32) * 3
    mask = rng.random(n) > 0.25
    if task == "graph_classification" and C == 1:
        y = rng.integers(0, 2, size=n)
    elif task == "graph_classification_multilabel":
        y = rng.integers(0, 2, size=(n, C)).astype(np.float32)
        y[rng.random((n, C)) < 0.3] = np.nan
    elif task == "graph_regression":
        y = rng.standard_normal((n, C)).astype(np.float32)
    else:
        y = rng.integers(-1, C, size=n)  # -1: a padded node
        if task == "node_classification":
            mask = y >= 0
    if empty_mask:
        mask[:] = False
    return logits, y, mask


@pytest.mark.parametrize("task,C,empty_mask", [
    ("graph_classification", 1, False),
    ("graph_classification_multilabel", 5, False),
    ("graph_classification", 4, False),
    ("node_classification", 3, False),
    ("graph_regression", 3, False),
    ("graph_classification", 1, True),       # denominator max(sum(mask), 1)
    ("graph_classification_multilabel", 5, True),
])
def test_losses_match_jax(task, C, empty_mask):
    logits, y, mask = _task_inputs(np.random.default_rng(0), task, C, 24, empty_mask)
    want = jax_loop.make_loss_fn(_FixedLogits(logits), task, C)(
        None, None, None, jnp.asarray(y), jnp.asarray(mask))
    got = loop.make_loss_fn(lambda g, x, impl=None: torch.from_numpy(logits), task, C)(
        None, None, torch.from_numpy(y), torch.from_numpy(mask))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def test_unknown_task_raises():
    with pytest.raises(ValueError):
        loop.make_loss_fn(None, "link_prediction", 1)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_and_schedule_match_optax(weight_decay):
    """45 updates from the same numpy gradients: Adam (AdamW with weight
    decay) with the rate halved every 20 updates.  atol 1e-6 covers
    parameters that pass near zero."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = rng.standard_normal((45, 6, 5)).astype(np.float32)
    kw = dict(lr=1e-2, step_lr_every=20, step_lr_gamma=0.5, weight_decay=weight_decay)

    jstate = jax_loop.TrainState.create(None, {"w": jnp.asarray(p0)}, **kw)
    jloss = lambda params, g, x, y, mask: jnp.sum(params["w"] * x)  # noqa: E731
    for g in grads:
        jstate, _ = jax_loop.train_step(jstate, jloss, None, jnp.asarray(g), None, None)

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    state = loop.TrainState.create(module, **kw, device="cpu")
    tloss = lambda g, x, y, mask: torch.sum(module.w * x)  # noqa: E731
    for g in grads:
        state, _ = loop.train_step(state, tloss, None, torch.from_numpy(g), None, None)

    assert isinstance(state.opt, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    assert state.opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5 ** 2)
    np.testing.assert_allclose(module.w.detach().numpy(), np.asarray(jstate.params["w"]),
                               rtol=1e-5, atol=1e-6)


def test_without_schedule_the_rate_stays():
    module = torch.nn.Linear(2, 2)
    state = loop.TrainState.create(module, lr=3e-3, device="cpu")
    assert state.sched is None
    for _ in range(25):
        loop.train_step(state, lambda *a: module.weight.sum(), None, None, None, None)
    assert state.opt.param_groups[0]["lr"] == 3e-3
