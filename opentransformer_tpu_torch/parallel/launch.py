"""Starting a world of ranks (the port's counterpart of JAX's single-process
mesh and of ``jax.distributed.initialize()``).

One process per card, or per CPU rank. ``spawn`` starts ``nprocs`` local
ranks of a function (the CLIs' ``-n N``) with a rendezvous on a free
localhost port; ``init_from_env`` joins the world that ``torchrun`` describes
in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; the CLIs' ``--multihost``). The backend follows the device:
NCCL for CUDA, Gloo for the CPU, unless the caller names one (two ranks that
share one card cannot use NCCL, which refuses a duplicate device; Gloo
carries all-reduce and broadcast of CUDA tensors). It is never swapped after
a failure.

A rank that raises ends the world: ``spawn`` terminates the other ranks and
raises in the parent, so a CLI exits non-zero instead of hanging in a
collective. Only rank 0 writes logs, checkpoints and results
(``is_rank0``).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:(local_rank mod cards)``, or the CPU."""
    if device_type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device_type)


def _child(rank: int, fn, nprocs: int, port: int, backend: str, args: tuple) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=nprocs, rank=rank, timeout=TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), backend: str = "gloo", join: bool = True):
    """Run ``fn(rank, *args)`` on ``nprocs`` local ranks of a new world;
    raises if any rank fails (the others are terminated). With ``join``
    False, returns the processes' context at once: ``join_all`` waits."""
    import torch.multiprocessing as mp

    return mp.start_processes(_child, args=(fn, nprocs, free_port(), backend, args),
                              nprocs=nprocs, join=join, start_method="spawn")


def join_all(context) -> None:
    """Wait for a world started with ``spawn(..., join=False)``; raises as
    ``spawn`` does."""
    while not context.join():
        pass


def init_single(backend: str) -> None:
    """A world of one rank (``-n 1``): the mesh and its collectives exist,
    each a no-op or a call over one rank."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=TIMEOUT)


def init_from_env(backend: str) -> int:
    """Join the world ``torchrun`` describes; returns the local rank."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if key not in os.environ:
            raise RuntimeError(f"--multihost needs {key} in the environment (as torchrun "
                               "sets it)")
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    logger.info("multihost: process %d/%d", dist.get_rank(), dist.get_world_size())
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
