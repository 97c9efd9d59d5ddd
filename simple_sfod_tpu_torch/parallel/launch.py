"""One process a device (the counterpart of Detectron2's `launch`, which the
reference's tools call, and of the JAX package's per-host
`initialize_distributed`).

    launch(fn, num_local, num_machines=1, machine_rank=0, dist_url=None,
           backend=None, device="cuda", args=(), threads=None)

runs fn(*args) in `num_local` processes on this machine, spawned (or in
this process when there is one), each joined to the world of num_local x
num_machines ranks at `dist_url` with global rank machine_rank x num_local
+ its local rank, and leaves the group when fn returns. One machine without
`dist_url` takes a free localhost port; a world of 1 without one joins no
group. On CUDA local rank i takes device i: more local processes than
devices raise. The backend is nccl on CUDA and gloo on the CPU unless
`backend` names one: several ranks on one GPU need gloo (NCCL refuses two
ranks on one device), and both come to share that device. `threads` sets
each process's CPU threads. A process that raises makes `launch` raise,
and the others are stopped.
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from . import mesh


def free_port() -> int:
    """A TCP port that is free on localhost now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(local_rank: int, fn: Callable, num_local: int, world: int, machine_rank: int, dist_url: Optional[str],
         backend: str, device: str, args: Sequence[Any], threads: Optional[int]):
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    rank = machine_rank * num_local + local_rank
    joined = mesh.initialize_distributed(dist_url, world, rank, backend)
    if joined:
        where = f"cuda:{torch.cuda.current_device()}" if torch.device(device).type == "cuda" else "cpu"
        print(f"[launch] rank {rank} of {world}: backend {backend}, device {where}", flush=True)
    try:
        return fn(*args)
    finally:
        if joined:
            dist.destroy_process_group()


def launch(
    fn: Callable,
    num_local: int,
    num_machines: int = 1,
    machine_rank: int = 0,
    dist_url: Optional[str] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
    args: Sequence[Any] = (),
    threads: Optional[int] = None,
):
    """See the module docstring. Returns fn's result when it runs in this
    process (one local process), else None."""
    num_local, num_machines = max(int(num_local), 1), max(int(num_machines), 1)
    world = num_local * num_machines
    if not 0 <= machine_rank < num_machines:
        raise ValueError(f"--machine-rank {machine_rank} is not in [0, {num_machines})")
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda and num_local > torch.cuda.device_count():
        raise ValueError(f"--num-gpus {num_local} exceeds the {torch.cuda.device_count()} visible CUDA device(s); "
                         "several ranks on one GPU are separate processes: --num-machines N --machine-rank r "
                         "--dist-url tcp://host:port --dist-backend gloo")
    backend = backend or mesh.default_backend(device)
    if backend == "nccl" and not is_cuda:
        raise ValueError("--dist-backend nccl needs CUDA; the CPU takes gloo")
    if dist_url is None and world > 1:
        if num_machines > 1:
            raise ValueError(f"--num-machines {num_machines} needs --dist-url (the address of machine 0)")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    if num_local == 1:
        return _run(0, fn, 1, world, machine_rank, dist_url, backend, device, args, threads)
    torch.multiprocessing.start_processes(
        _run, args=(fn, num_local, world, machine_rank, dist_url, backend, device, tuple(args), threads),
        nprocs=num_local, join=True, start_method="spawn",
    )
    return None
