"""The port's metrics against the JAX package's (CPU).  The JAX package
calls scikit-learn; the port computes the same definitions with numpy and
scipy, because the card's machine has no scikit-learn."""

import numpy as np
import pytest

from dfgnn_tpu.train import loop as jax_loop
from dfgnn_tpu_torch.train import loop


def _scores(rng, n, tied):
    s = rng.standard_normal(n)
    return np.round(s, 1) if tied else s


@pytest.mark.parametrize("tied", [False, True])
def test_rocauc_matches_jax(tied):
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, size=300)
    s = _scores(rng, 300, tied) + 0.5 * y
    assert loop.evaluate_rocauc(y, s) == pytest.approx(jax_loop.evaluate_rocauc(y, s), abs=1e-12)
    assert np.isnan(loop.evaluate_rocauc(np.ones(5), s[:5]))
    assert np.isnan(jax_loop.evaluate_rocauc(np.ones(5), s[:5]))


@pytest.mark.parametrize("tied", [False, True])
def test_mean_ap_matches_jax(tied):
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, size=(200, 6)).astype(np.float32)
    y[rng.random(y.shape) < 0.2] = np.nan
    y[:, 4] = 1.0           # one class only: skipped
    y[:, 5] = np.nan        # no label at all: skipped
    s = _scores(rng, 200 * 6, tied).reshape(200, 6) + np.nan_to_num(y)
    mask = rng.random(200) > 0.1
    for m in (None, mask):
        want = jax_loop.evaluate_mean_ap(y, s, mask=m)
        assert loop.evaluate_mean_ap(y, s, mask=m) == pytest.approx(want, abs=1e-12)
    assert np.isnan(loop.evaluate_mean_ap(y[:, 4:], s[:, 4:]))
    assert np.isnan(jax_loop.evaluate_mean_ap(y[:, 4:], s[:, 4:]))


def test_accuracy_matches_jax():
    rng = np.random.default_rng(4)
    y, p, m = rng.integers(0, 3, 50), rng.integers(0, 3, 50), rng.random(50) > 0.3
    for mask in (None, m):
        assert loop.evaluate_accuracy(y, p, mask) == jax_loop.evaluate_accuracy(y, p, mask)
