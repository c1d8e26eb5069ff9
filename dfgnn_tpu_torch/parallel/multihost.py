"""Multi-process set-up under ``torchrun``.

The counterpart of :mod:`dfgnn_tpu.parallel.multihost`.  The JAX package
starts ``jax.distributed`` when a TPU pod launcher's variables are set
(``JAX_COORDINATOR_ADDRESS``, ``MEGASCALE_COORDINATOR_ADDRESS``,
``TPU_WORKER_COUNT``); those have no meaning here.  The port runs one process
per GPU, launched by ``torchrun``, which sets ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``:

    torchrun --nproc-per-node 4 -m dfgnn_tpu_torch.scripts.bench_scaling --dataset reddit

    from dfgnn_tpu_torch.parallel import initialize, make_mesh, partition_graph
    initialize()                      # a no-op in one process
    mesh = make_mesh()                # every rank of the world
    pg = partition_graph(g, mesh.size(), mesh=mesh)
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.parallel.comm import default_backend


def _world_size_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or "1")


def initialize(device="cuda", backend: Optional[str] = None, **kwargs) -> bool:
    """Starts the default process group when torchrun's environment says
    ``WORLD_SIZE`` > 1, after ``torch.cuda.set_device(LOCAL_RANK)`` on the
    card; returns True then, and False (doing nothing) otherwise.  The
    backend is ``backend``, else :func:`~.comm.default_backend` of
    ``device``; ``kwargs`` go to ``init_process_group``."""
    if _world_size_env() <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0") or "0"))
    dist.init_process_group(backend=backend or default_backend(dev), **kwargs)
    return True


def free_port() -> int:
    """A free TCP port on localhost (the OS's pick for port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_or_single(device="cuda", backend: Optional[str] = None,
                         timeout: Optional[datetime.timedelta] = None) -> bool:
    """:func:`initialize` under torchrun; run without it, a world of this one
    process on a free localhost port, so the distributed paths run alike.
    Returns True when it started the default group (the caller then destroys
    it), False when one was there already."""
    if dist.is_initialized():
        return False
    kw = {} if timeout is None else {"timeout": timeout}
    if initialize(device, backend, **kw):
        return True
    dist.init_process_group(backend=backend or default_backend(resolve_device(device)),
                            init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, **kw)
    return True


def process_local_batch(global_batch_size: int) -> slice:
    """The slice of a global batch this process loads: equal contiguous
    shares in rank order (the whole batch in one process)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)
