"""Process-group start-up for the sharded frame (port of
``drts_tpu/parallel/multihost.py``).

The reference calls ``jax.distributed.initialize`` from arguments or
JAX's variables and then sees the global device set. Here every rank is
one process: ``initialize`` starts ``torch.distributed`` from arguments
or torchrun's variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), NCCL for a ``cuda`` device (one card per rank:
NCCL refuses two ranks on one device) and gloo for ``cpu``, or gloo on the
card where the caller names it. With no coordinator configured it does
nothing and returns False, as the reference does, and the helpers fall
back to one process. ``spawn`` starts n ranks of a function on this host,
each with its own process group.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import backend
from . import mesh as mesh_mod

BACKENDS = ("nccl", "gloo")


def _device_and_backend(device, backend_name, local_rank):
    """(torch.device of this rank, backend name). NCCL takes a card per
    rank; gloo runs on the CPU or shares the card."""
    dev = backend.device(device)
    if backend_name is None:
        backend_name = "nccl" if dev.type == "cuda" else "gloo"
    if backend_name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend_name!r}")
    if backend_name == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a cuda device, got {dev}")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if backend_name == "nccl" and local_rank >= count:
            raise ValueError(f"nccl needs one card per rank: local rank "
                             f"{local_rank} of {count} card(s)")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    return dev, backend_name


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               backend_name: str | None = None) -> bool:
    """Start the default process group from the arguments or torchrun's
    variables: the coordinator "host:port" (``MASTER_ADDR`` and
    ``MASTER_PORT``), the world size (``WORLD_SIZE``) and this rank
    (``RANK``; ``LOCAL_RANK`` picks the card). Returns True once a group
    exists (also one that was already started); False, with nothing
    started, when no coordinator or world size is configured. The backend
    is NCCL for a cuda `device` and gloo for cpu, or `backend_name`; one
    that does not fit the device raises, as does cuda without a card."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "0") or 0)
    if process_id is None:
        process_id = int(env.get("RANK", "0") or 0)
    if not coordinator_address or num_processes < 1:
        return False
    local_rank = int(env.get("LOCAL_RANK", process_id))
    dev, name = _device_and_backend(device, backend_name, local_rank)
    kw = {"device_id": dev} if name == "nccl" else {}
    dist.init_process_group(name, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(minutes=10), **kw)
    return True


def global_group():
    """The group of every rank (None before ``initialize``)."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the card ``initialize`` made current for a
    cuda `device`, else `device`."""
    dev = backend.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_local_rows(height: int) -> tuple[int, int]:
    """The [start, end) image rows this process renders under the row
    bands of the global group (all of them for a single process), the
    counterpart of the reference's helper: a rank of the global group
    holds these rows of each render-height buffer between frames
    (``graft_entry.frames_worker`` reports them)."""
    if not dist.is_initialized():
        return 0, height
    return mesh_mod.row_band(height, dist.get_rank(), dist.get_world_size())


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, fn, nprocs, port, device, backend_name, args):
    os.environ["LOCAL_RANK"] = str(rank)
    initialize(f"127.0.0.1:{port}", nprocs, rank, device=device,
               backend_name=backend_name)
    try:
        fn(dist.group.WORLD, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, device="cuda", backend_name: str | None = None,
          args: tuple = ()) -> None:
    """Run ``fn(group, *args)`` in `nprocs` new processes on this host, one
    rank each of a fresh process group over localhost (`fn` must be a
    module-level function). Returns when all have ended; a rank that
    raises makes this raise."""
    mp.start_processes(_rank_main, nprocs=nprocs, join=True,
                       start_method="spawn",
                       args=(fn, nprocs, free_port(), device, backend_name,
                             args))
