"""The ray axis over several cards: one process per card.

Counterpart of the JAX package's ``parallel/sharding.py`` (``make_mesh``,
``shard_rays``, ``replicate``, ``pad_to_multiple``). Where JAX puts a
one-axis mesh ``("rays",)`` over the devices of one process, the port runs
one process per card in a ``torch.distributed`` process group: NCCL
between cards, gloo on the CPU (or, passed as ``backend``, gloo between
ranks that share one card, which NCCL refuses). Each rank holds the whole
model and scene (JAX's replicated state) and its contiguous share of the
ray axis (JAX's ``P("rays")``):

  * rendering (``pipeline/renderer.py``) needs no collective until rank 0
    gathers the rendered rays;
  * training (``pipeline/fit.py``) sums the ranks' gradients once per
    optimizer step (JAX's psum).

``spawn`` starts the ranks of one machine (``torch.multiprocessing``,
spawn, a rendezvous on a free local port); under ``torchrun``
``start_from_env`` joins the group it describes. Imports no ``jax``.
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple with edge rows; returns (padded,
    original_length)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad, mode="edge"), n


def shard_bounds(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous share ``[start, stop)`` of ``n`` rows
    split over ``world`` ranks; ``n`` must divide evenly, as JAX's
    ``P("rays")`` requires."""
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def shard_rays(arr, rank: int, world: int):
    """Rank ``rank``'s share of a ray-major array (axis 0): the block
    ``shard_rays(make_mesh(world), arr)`` places on device ``rank`` in
    JAX."""
    start, stop = shard_bounds(arr.shape[0], rank, world)
    return arr[start:stop]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The ranks of the process group; 1 outside one."""
    return dist.get_world_size() if is_initialized() else 1


def backend_for(device) -> str:
    """NCCL for CUDA cards, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank}`` for ``"cuda"``, an
    indexed card as given (``"cuda:0"``: every rank on that card), the
    CPU for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def start(rank_: int, world: int, init_method: str, device="cuda",
          backend: Optional[str] = None, local_rank: Optional[int] = None
          ) -> torch.device:
    """Join the process group as ``rank_`` of ``world``; returns this
    rank's device (``rank_device``), made the current card."""
    dev = rank_device(device, rank_ if local_rank is None else local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(dev), init_method=init_method,
                            world_size=world, rank=rank_)
    return dev


def torchrun_world() -> Optional[int]:
    """The world size ``torchrun`` gave this process (``WORLD_SIZE``), or
    None outside it."""
    w = os.environ.get("WORLD_SIZE")
    return int(w) if w and "RANK" in os.environ and "MASTER_ADDR" in os.environ else None


def start_from_env(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)."""
    return start(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                 device, local_rank=int(os.environ.get("LOCAL_RANK", 0)))


def stop() -> None:
    if is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank_: int, fn: Callable, world: int, init_method: str, device,
           backend: Optional[str], threads: int, out_dir: str, args: Sequence) -> None:
    dev = start(rank_, world, init_method, device, backend)
    if dev.type == "cpu":
        # the ranks share the machine's cores
        torch.set_num_threads(max(1, threads // world))
    try:
        result = fn(dev, *args)
        with open(os.path.join(out_dir, f"{rank_}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        stop()


def spawn(fn: Callable, world: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None) -> List:
    """Run ``fn(device_of_the_rank, *args)`` in ``world`` new processes,
    ranks 0..world-1 of one process group on this machine (rendezvous on
    ``tcp://localhost:<free port>``); returns each rank's return value, in
    rank order. ``fn`` must be importable by name (the workers start from
    a fresh interpreter); a rank that raises makes this raise. On the CPU
    the ranks split this process's torch threads."""
    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="uforecon_ranks_") as out_dir:
        torch.multiprocessing.start_processes(
            _entry, args=(fn, world, init_method, device, backend,
                          torch.get_num_threads(), out_dir, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective's buffer lives: the card under NCCL, the CPU
    under gloo (which takes CPU tensors for every collective)."""
    return t.device if dist.get_backend() == "nccl" else torch.device("cpu")


def gather_rows(tensors: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """Each tensor's shares of the ranks (equal shapes), concatenated
    along axis 0 in rank order, on the CPU of rank 0; None on the other
    ranks. One all_gather per tensor; outside a process group, the
    tensors on the CPU."""
    world = world_size()
    if world == 1:
        return [t.cpu() for t in tensors]
    out = []
    for t in tensors:
        t = t.to(_comm_device(t)).contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out.append(torch.cat(parts).cpu())
    return out if rank() == 0 else None


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place: one all_reduce of their
    concatenation; outside a process group, nothing."""
    tensors = list(tensors)
    if not tensors or world_size() == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = flat.to(_comm_device(flat))
    dist.all_reduce(flat)
    with torch.no_grad():
        for t, v in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Give every rank rank ``src``'s parameters and buffers. The values
    are written with ``copy_``, which bumps each tensor's ``_version``, so
    the head kernels' weight-pack cache (``ops/cuda_build.PackCache``)
    builds anew from the broadcast weights. Outside a process group,
    nothing."""
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.numel()]
    if not tensors or world_size() == 1:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        flat = flat.to(_comm_device(flat))
        dist.broadcast(flat, src)
        for t, v in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(v.view_as(t).to(t.dtype))


def barrier() -> None:
    if is_initialized():
        dist.barrier()
