"""Process groups: one rank per device.

Port of ``dxrvoxelizer_tpu/parallel/mesh.py``. The JAX package shards a frame
over a 1-D ``jax.sharding.Mesh``; here every device is one rank of a
``torch.distributed`` process group, NCCL with one rank per card
(``cuda:rank``) on GPUs, gloo on the CPU (``-warp``). A :class:`DeviceGroup`
holds the rank, the world size, the rank's device and the backend, and runs
the frame's one collective (:meth:`DeviceGroup.all_gather`).

- :func:`make_device_mesh` builds a group from the process group the caller
  initialised (``torchrun``, or :func:`spawn_ranks`), or initialises one of
  a single rank. Asking for more cards than the machine has raises; nothing
  falls back to the CPU.
- :func:`spawn_ranks` starts N ranks as processes on this machine, each with
  its group initialised, and joins them.
- :func:`make_local_group` is the checking harness: a group whose frames run
  every rank's body in this process and concatenate the pieces as the
  all_gather would (parallel/shard.py ``ShardedFrame``). It is not a product
  path: ``-chips N`` always runs N ranks.

Importing this module starts no process group.
"""

from __future__ import annotations

import os
import socket
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DeviceGroup:
    """One rank's view of the group: ``backend`` "nccl" or "gloo" (a
    ``torch.distributed`` group), or "local" (:func:`make_local_group`).
    ``owned``: this group was initialised by :func:`make_device_mesh`, and
    :meth:`close` destroys it."""

    rank: int
    world: int
    device: torch.device
    backend: str
    owned: bool = False

    @property
    def local(self) -> bool:
        return self.backend == "local"

    def all_gather(self, piece: torch.Tensor,
                   sizes: list[int] | None = None) -> torch.Tensor:
        """Every rank's ``piece``, concatenated along dim 0 in rank order:
        one ``dist.all_gather``. ``sizes``: each rank's row count (default:
        all equal); shorter pieces travel zero-padded to the longest and are
        cut back after."""
        if self.local:
            raise RuntimeError("a local group runs every rank in this process; "
                               "it has no collective")
        sizes = [int(piece.shape[0])] * self.world if sizes is None else sizes
        if int(piece.shape[0]) != sizes[self.rank]:
            raise ValueError(f"rank {self.rank}: piece of {piece.shape[0]} "
                             f"rows, expected {sizes[self.rank]}")
        rows = max(sizes)
        if piece.shape[0] < rows:
            pad = piece.new_zeros((rows - piece.shape[0], *piece.shape[1:]))
            piece = torch.cat([piece, pad])
        piece = piece.contiguous()
        outs = [torch.empty_like(piece) for _ in range(self.world)]
        dist.all_gather(outs, piece)
        return torch.cat([o[:s] for o, s in zip(outs, sizes)])

    def close(self) -> None:
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_cards(n: int) -> None:
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise ValueError(
            f"requested {n} devices, found {found}; pass -warp to run {n} "
            "gloo ranks on the CPU")


def _local_rank(rank: int) -> int:
    """The card of this rank on its machine (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def make_device_mesh(n_devices: int | None = None,
                     cpu: bool = False) -> DeviceGroup:
    """This rank's :class:`DeviceGroup`.

    With a process group initialised: its rank and world size (which must
    equal ``n_devices`` when given), the card ``cuda:LOCAL_RANK`` under NCCL
    and the CPU under gloo. Without one: ``n_devices`` (default 1) must be
    1, and a group of one rank is initialised here, NCCL on the card or,
    with ``cpu``, gloo. On a GPU machine with fewer than ``n_devices`` cards
    it raises ("requested N devices, found M"); it never falls back to the
    CPU."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"requested {n_devices} devices, the process "
                             f"group has {world} ranks")
        backend = dist.get_backend()
        if backend == "nccl":
            device = torch.device("cuda", _local_rank(rank))
        else:
            device = torch.device("cpu")
        return DeviceGroup(rank, world, device, backend)
    n = 1 if n_devices is None else n_devices
    if not cpu:
        _check_cards(n)
    if n > 1:
        raise RuntimeError(
            f"{n} ranks need a process group: start them with spawn_ranks "
            "(the app's -chips N) or torchrun")
    backend = "gloo" if cpu else "nccl"
    device = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if not cpu:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    return DeviceGroup(0, 1, device, backend, owned=True)


def make_local_group(world: int, device: torch.device | str) -> DeviceGroup:
    """The checking harness: ``world`` ranks run one after another in this
    process, all on ``device``."""
    if world < 1:
        raise ValueError(f"world size must be positive, got {world}")
    return DeviceGroup(0, world, torch.device(device), "local")


def _rank_entry(rank: int, world: int, backend: str, init_method: str, fn,
                args: tuple) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), cpu: bool = False) -> None:
    """Run ``fn(*args)`` in ``world`` new processes, rank r on ``cuda:r``
    under NCCL, or on the CPU under gloo with ``cpu``; each initialises its
    group (a file store in a temporary directory), calls ``fn`` and destroys
    the group. Joins them all; raises if one fails. ``fn`` must be importable
    by name (the processes are spawned, not forked)."""
    if not cpu:
        _check_cards(world)
    backend = "gloo" if cpu else "nccl"
    with tempfile.TemporaryDirectory(prefix="dxv_ranks_") as td:
        init_method = "file://" + os.path.join(td, "store")
        torch.multiprocessing.start_processes(
            _rank_entry, args=(world, backend, init_method, fn, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
