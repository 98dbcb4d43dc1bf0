"""Joining a process group from torchrun's environment.

Counterpart of unsupervised_pseuso_lidar_tpu/parallel/distributed.py
(initialize :20, global_mesh :48). JAX joins a multi-host cluster with
jax.distributed and the same program then spans the global mesh; here
each rank is a process of a torch.distributed group, started by torchrun
(`torchrun --nproc-per-node N -m unsupervised_pseuso_lidar_tpu_torch.cli.train
--mesh N`) or spawned by `cli.train --mesh N`.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh, make_mesh
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

# torchrun's rendezvous variables; without them there is no group to join
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join a process group (idempotent), from the arguments or else from
    torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK.

    Returns False, and does nothing, when neither names a group: a
    single-process run needs no initialization. Otherwise the backend is
    NCCL for a CUDA `device` and gloo for the CPU (or `backend`), and a
    bare "cuda" device becomes cuda:LOCAL_RANK (the process id without
    torchrun), the current device from then on. Returns True."""
    if coordinator_address is None:
        if not all(v in os.environ for v in ENV_VARS):
            return False
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(index)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago: the rendezvous
    of a group whose ranks all run on this host."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def global_mesh(spatial: int = 1, device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every rank of the process group (parallel/mesh.make_mesh)."""
    return make_mesh(spatial=spatial, device=device)
