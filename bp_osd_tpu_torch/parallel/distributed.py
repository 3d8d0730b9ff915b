"""Multi-process runs over ``torch.distributed``.

Port of ``bp_osd_tpu/parallel/distributed.py``.  Each process (rank) decodes
its slice of every globally sharded batch (:func:`host_batch_slice`), on its
own card by default (:func:`local_card`), and the harness reduces its
per-batch integers across the ranks (:func:`reduce_batch_counts`) as a CPU
int64 tensor over a gloo group, so the same path serves ranks on the CPU,
ranks that share one card and one rank a card.  The process group is gloo;
nothing here asks for NCCL.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["host_batch_slice", "initialize", "is_multi_host", "local_card",
           "process_count", "process_index", "reduce_batch_counts"]

_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the gloo process group; True once a group is up.

    With explicit arguments (``coordinator_address`` as ``"host:port"``,
    the process count and this process's rank, all three) every failure
    raises.  With none it reads a launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them)
    and returns False when there is none (a single process).  A second call
    with a group already up returns True.
    """
    if dist.is_initialized():
        return True
    given = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in given):
        if any(a is None for a in given):
            raise ValueError("give coordinator_address, num_processes and process_id together")
        host, sep, port = str(coordinator_address).rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"coordinator_address must be 'host:port', got "
                             f"{coordinator_address!r}")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id {process_id} is outside [0, {num_processes})")
        dist.init_process_group("gloo", init_method=f"tcp://{host}:{port}",
                                world_size=int(num_processes), rank=int(process_id))
        return True
    if not all(k in os.environ for k in _LAUNCHER_ENV):
        return False
    dist.init_process_group("gloo", init_method="env://")
    return True


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_card() -> torch.device:
    """This process's card: its ``LOCAL_RANK`` (as ``torchrun`` sets it),
    else its rank, modulo the number of cards."""
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def is_multi_host() -> bool:
    return process_count() > 1


def host_batch_slice(total_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of a globally sharded batch."""
    per_host = total_batch // process_count()
    return process_index() * per_host, per_host


def reduce_batch_counts(sums: list[int], minimum: int) -> tuple[list[int], int]:
    """The ranks' ``sums`` added and their ``minimum`` taken, exactly, from
    one all-gather of CPU int64 tensors over the gloo group of
    :func:`initialize` (one collective a batch, not one a reduction); every
    rank gets the same totals."""
    mine = torch.tensor([*sums, minimum], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(every, mine)
    every = torch.stack(every)
    return every[:, :-1].sum(0).tolist(), int(every[:, -1].min())
