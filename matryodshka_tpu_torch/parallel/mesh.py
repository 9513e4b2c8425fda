"""Process groups: the port's counterpart of
`matryodshka_tpu/parallel/mesh.py`.

The JAX package lays its devices out as one Mesh with the axes 'data' (the
trainer's batch shards, parallel/dp.py) and 'shell' (the high-res
render's shell blocks, parallel/sharded_render.py), in one process.
PyTorch runs a process per rank: each axis here is the default process
group of the processes a run started, NCCL on cards and gloo on the CPU.
A run gets its ranks from `torchrun` (init_from_env) or starts them itself
(run_ranks, which the trainer CLI, entry.dryrun_multichip and the tests
use, with a file store, so no port is opened).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: The JAX mesh's axis names: what each process group stands for.
DATA = "data"
SHELL = "shell"


def backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of a rank: card rank mod the cards here, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init(rank: int, world_size: int, init_method: str, device) -> None:
    """Join the default process group as rank of world_size
    (init_method: 'file://<path>' or 'tcp://host:port'), with the
    device's backend; a CUDA device becomes the current one."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend(device), init_method=init_method,
                            rank=rank, world_size=world_size)


def init_from_env(device_type: str) -> Optional[torch.device]:
    """Join the group that torchrun describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) unless one is joined already -> this rank's
    device; None when the process was not started as a rank."""
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        rank = int(os.environ["RANK"])
        device = rank_device(device_type, int(os.environ.get(
            "LOCAL_RANK", rank)))
        init(rank, int(os.environ["WORLD_SIZE"]), "env://", device)
        return device
    return rank_device(device_type, dist.get_rank())


def rank_and_size(group=None) -> Tuple[int, int]:
    """(rank, world size) of group; (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _rank_main(rank, fn, world_size, init_method, device_type, args):
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    init(rank, world_size, init_method, rank_device(device_type, rank))
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, store_path: str,
              device_type: str = "cpu", args=(),
              timeout: Optional[float] = 600.0):
    """Run fn(rank, world_size, *args) in world_size new processes, each
    in the default group (a file store at store_path, which must not
    exist yet), on its rank_device. fn must be importable (a module-level
    function). Raises if a rank fails or, unless timeout is None, the
    ranks have not all ended within timeout seconds (then every rank is
    killed)."""
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, f"file://{store_path}",
                          device_type, args),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=None if deadline is None else max(
                0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"did not end within {timeout:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
