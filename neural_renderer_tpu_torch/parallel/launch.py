"""Ranks for the multi-GPU paths: one process per rank.

The JAX package drives every device from one process (`shard_map` and
GSPMD); this package runs one process per rank under `torch.distributed`.
`spawn(fn, world, device, *args)` starts `world` ranks with
`torch.multiprocessing` (start method "spawn"), each of which joins a
process group and calls `fn(rank, world, device, *args)`:

  * rank r runs on `cuda:(r % device_count)`, or on the CPU under
    device "cpu";
  * the backend is NCCL when every rank has a GPU of its own, else gloo
    (on the CPU, or when ranks share a card; the collectives in
    parallel/shardings.py then stage CUDA tensors through host memory,
    and the compute stays on the card);
  * the group meets through a `file://` store in a temporary directory
    (no TCP port to collide) with a timeout of `timeout` seconds;
  * ranks other than 0 print nothing on stdout; a rank that raises ends
    the whole command with the error.

Kernels are built once, before the ranks start (`cuda_build.build()`).
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

# Seconds a collective may wait for the other ranks.
GROUP_TIMEOUT = 60


def backend_for(device, world: int) -> str:
    """"nccl" when each of `world` ranks on `device` gets a GPU of its own,
    else "gloo"."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The device of `rank`: cuda:(rank % device_count), or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def ranks_per_gpu(world: int, device) -> int:
    """How many ranks share one card (0 on the CPU)."""
    if torch.device(device).type != "cuda":
        return 0
    return -(-world // torch.cuda.device_count())


def init_group(rank: int, world: int, store: str, device="cuda",
               timeout: float = GROUP_TIMEOUT) -> torch.device:
    """Join the process group of `world` ranks through the file `store`;
    returns the rank's device."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(device, world), init_method=f"file://{store}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    return dev


def describe(world: int, device) -> str:
    """The backend and the ranks per GPU, as the CLIs print them."""
    per = ranks_per_gpu(world, device)
    return (f"{world} ranks over {backend_for(device, world)}, "
            + (f"{per} rank(s) per GPU" if per else "on the CPU"))


def _rank_main(rank, fn, world, store, out_dir, device, timeout, threads,
               args):
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    torch.set_num_threads(threads)
    dev = init_group(rank, world, store, device, timeout)
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device, *args, timeout: float = GROUP_TIMEOUT,
          join_timeout: float | None = None,
          threads: int | None = None) -> list:
    """Run fn(rank, world, rank_device, *args) on `world` ranks; returns
    the ranks' results in rank order. `fn` must be a module-level function
    and its arguments picklable. `join_timeout` (seconds) bounds the whole
    run: past it the ranks are terminated and TimeoutError is raised.
    `threads`: each rank's intra-op threads (default: the cores shared
    out among the ranks)."""
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        from ..ops import cuda_build
        cuda_build.build()
    tmp = tempfile.mkdtemp(prefix="nr_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(tmp, "store"), tmp,
                              device, timeout, threads, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if join_timeout is None \
            else time.monotonic() + join_timeout
        while not ctx.join(None if deadline is None
                           else max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{join_timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
