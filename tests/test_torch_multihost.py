"""The port's multi-process set-up (``dfgnn_tpu_torch/parallel/multihost.py``)
beside the JAX package's ``tests/test_multihost.py``.

One process cannot start a real multi-process world here, so these pin the
decision logic, when ``initialize`` must (not) call
``torch.distributed.init_process_group`` (torchrun's ``WORLD_SIZE``; the
JAX package reads its TPU launcher's variables), and the per-process batch
slicing, through a monkeypatched environment, a stub
``init_process_group`` and stubbed rank metadata.  Nothing is spawned.
"""

from unittest import mock

import pytest
import torch.distributed as dist

from dfgnn_tpu_torch.parallel import multihost

TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_initialize_noop_single_process(clean_env):
    with mock.patch.object(dist, "init_process_group") as init:
        assert multihost.initialize(device="cpu") is False
        clean_env.setenv("WORLD_SIZE", "1")
        assert multihost.initialize(device="cpu") is False
        clean_env.setenv("WORLD_SIZE", "")
        assert multihost.initialize(device="cpu") is False
        init.assert_not_called()


@pytest.mark.parametrize("backend,want", [(None, "gloo"), ("nccl", "nccl")])
def test_initialize_fires_under_torchrun(clean_env, backend, want):
    """``WORLD_SIZE`` > 1 starts the default group, with gloo for the CPU
    unless a backend is named; keywords go through."""
    for k, v in dict(WORLD_SIZE="4", RANK="2", LOCAL_RANK="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29500").items():
        clean_env.setenv(k, v)
    with mock.patch.object(dist, "init_process_group") as init:
        assert multihost.initialize(device="cpu", backend=backend, group_name="g") is True
        init.assert_called_once_with(backend=want, group_name="g")


def test_initialize_on_the_card_needs_one(clean_env, monkeypatch):
    """The default device is the card: without one it raises rather than
    starting a CPU group."""
    clean_env.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with mock.patch.object(dist, "init_process_group") as init:
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize()
        init.assert_not_called()


def test_process_local_batch_partitions_evenly():
    with mock.patch.object(dist, "is_initialized", return_value=True), \
         mock.patch.object(dist, "get_world_size", return_value=4), \
         mock.patch.object(dist, "get_rank", return_value=2):
        assert multihost.process_local_batch(64) == slice(32, 48)
    covered = []
    with mock.patch.object(dist, "is_initialized", return_value=True), \
         mock.patch.object(dist, "get_world_size", return_value=4):
        for i in range(4):
            with mock.patch.object(dist, "get_rank", return_value=i):
                sl = multihost.process_local_batch(64)
                covered.extend(range(sl.start, sl.stop))
    assert covered == list(range(64))
    # one process loads the whole batch
    with mock.patch.object(dist, "is_initialized", return_value=False):
        assert multihost.process_local_batch(64) == slice(0, 64)
