"""Process-group bring-up for a mesh of ranks (counterpart of
``mp_hsir_tpu/parallel/distributed.py``, which initialises
``jax.distributed``).

A rank learns its place from explicit arguments or from the variables
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). On the card, rank r
runs on card ``LOCAL_RANK % n_cards`` (:func:`card_for_rank`): on a machine
with a card per rank each rank has its own, and where ranks outnumber the
cards they share them. The backend (:func:`pick_backend`) is NCCL when every
rank has a card of its own and gloo otherwise (ranks sharing a card, or on
the CPU). :func:`spawn` starts the ranks of one machine itself, for a
command started outside ``torchrun``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist


def card_for_rank(local_rank: int, n_cards: int) -> int:
    """The card a rank runs on: its local rank modulo the cards visible."""
    if n_cards < 1:
        raise ValueError("no card visible")
    return local_rank % n_cards


def pick_backend(device_type: str, local_world_size: int, n_cards: int) -> str:
    """NCCL where each of the machine's ranks has a card of its own; gloo
    where ranks share a card (NCCL takes one rank per card) or run on the
    CPU."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= n_cards else "gloo"


@dataclasses.dataclass(frozen=True)
class DistInfo:
    rank: int
    world_size: int
    backend: Optional[str]
    device: torch.device


def _env_int(name: str, given: Optional[int], default: int) -> int:
    if given is not None:
        return given
    v = os.environ.get(name)
    return int(v) if v else default


def initialize_distributed(device: str | torch.device = "cuda", rank: Optional[int] = None,
                           world_size: Optional[int] = None, local_rank: Optional[int] = None,
                           local_world_size: Optional[int] = None, addr: Optional[str] = None,
                           port: Optional[int] = None,
                           timeout_s: Optional[float] = None) -> DistInfo:
    """Set up this rank: its card (``torch.cuda.set_device``) and, with more
    than one rank, the default process group over ``tcp://addr:port``
    (``timeout_s``: its collectives' time limit, torch's default where
    None). Arguments left None come from torchrun's variables; a single rank
    starts no group. Returns where the rank runs."""
    world_size = _env_int("WORLD_SIZE", world_size, 1)
    rank = _env_int("RANK", rank, 0)
    local_rank = _env_int("LOCAL_RANK", local_rank, rank)
    local_world_size = _env_int("LOCAL_WORLD_SIZE", local_world_size, world_size)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no card is visible; pass --device cpu")
        dev = torch.device("cuda", card_for_rank(local_rank, torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    if world_size <= 1:
        return DistInfo(0, 1, None, dev)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = pick_backend(dev.type, local_world_size, n_cards)
    if not dist.is_initialized():
        addr = addr or os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = port or int(os.environ.get("MASTER_PORT", "29500"))
        kw = {} if timeout_s is None else dict(timeout=datetime.timedelta(seconds=timeout_s))
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world_size, **kw)
    return DistInfo(rank, world_size, backend, dev)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, n: int, port: int, device: str, result_path: str,
               timeout_s, args) -> None:
    info = initialize_distributed(device, rank=rank, world_size=n, local_rank=rank,
                                  local_world_size=n, addr="127.0.0.1", port=port,
                                  timeout_s=timeout_s)
    try:
        out = fn(info, *args)
    finally:
        shutdown()
    if rank == 0:
        torch.save(out, result_path)


def spawn(fn: Callable, n: int, *args, device: str = "cuda", timeout_s: Optional[float] = None):
    """Run ``fn(info, *args)`` on ``n`` ranks of this machine, each a fresh
    process (started with 'spawn', so CUDA starts anew in each), joined over
    a free localhost port; returns rank 0's return value (passed back
    through a file). A rank that raises fails the whole run: the others are
    stopped and this raises. ``fn`` must be importable (a module-level
    function); ``timeout_s`` bounds each collective."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank_main, args=(fn, n, free_port(), str(device), path, timeout_s,
                                             args),
                           nprocs=n, join=True, start_method="spawn")
        return torch.load(path, weights_only=False)
