"""Process set-up for runs across processes.

The counterpart of ``replicatinggpt_tpu/parallel/distributed.py`` for
``torchrun``: one process per card. Without a launcher (``WORLD_SIZE``
unset or 1) the run is one process and every shard lives in it.

- Training: each process holds one data shard (its B/data rows of every
  global batch, ``parallel.mesh.ProcessDataGroup``) and, with a seq axis,
  one shard of each of those sequences (``ProcessSeqGroup`` over its data
  row's subgroup); without a launcher one process holds every shard
  (``LocalDataGroup``, ``LocalSeqGroup``). ``WORLD_SIZE`` must equal
  data x seq. Each process draws its own rows: ``local_batch_slice``,
  and for random windows ``per_process_seed`` (the JAX package's
  functions of the same names).
- Serving on a (data, model) mesh: each process holds one shard
  (``parallel.serve_group.ProcessServeGroup``; ``LocalServeGroup`` in one
  process), so ``WORLD_SIZE`` must equal data x model.

    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-small --dp 4 --batch-size 128
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-medium --dp 4 --fsdp
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch train \\
        --preset gpt2-xl --sp 4
    torchrun --nproc-per-node 4 -m replicatinggpt_tpu_torch serve-replay \\
        --preset gpt2-small --decode-cache-layout packed --paged-kernel \\
        --mesh-shape 2x2
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import LocalDataGroup, LocalSeqGroup, ProcessDataGroup


def world_size() -> int:
    """Processes of this launch (``torchrun``'s ``WORLD_SIZE``; 1 without
    a launcher)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(device=None, data: int = 1, seq: Optional[int] = None,
               mesh: Optional[Tuple[int, int]] = None) -> torch.device:
    """Join the launch's process group (``torchrun``'s ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    NCCL on the card ``cuda:LOCAL_RANK``, or gloo when ``device`` is the
    CPU. Returns the process's device. Raises when ``WORLD_SIZE`` is not
    ``data`` x ``seq`` for training, or not data x model for a serving
    ``mesh``."""
    n = world_size()
    if seq is not None and n != data * seq:
        raise ValueError(f"{n} processes for data {data} x seq {seq}: "
                         f"every process is one shard of the training "
                         f"mesh, so launch {data * seq} (or --dp / --sp to "
                         f"match)")
    if mesh is not None and n != mesh[0] * mesh[1]:
        raise ValueError(f"{n} processes for --mesh-shape {mesh[0]}x"
                         f"{mesh[1]}: every process is one shard of the "
                         f"serve mesh, so launch {mesh[0] * mesh[1]}")
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None or torch.device(device).type == "cuda":
        dev = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = resolve_device(device)
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=n)
    return dev


def local_seq_slice(T: int) -> slice:
    """This process's columns of a (B, T) batch: all of them in one
    process, else the rank's T / WORLD_SIZE."""
    if not dist.is_initialized():
        return slice(0, T)
    n, r = dist.get_world_size(), dist.get_rank()
    if T % n:
        raise ValueError(f"sequence length {T} does not split into {n} "
                         f"shards")
    return slice(r * T // n, (r + 1) * T // n)


def local_batch_slice(global_batch_size: int, n: int, index: int) -> slice:
    """Rows of the global (B, T) batch that data shard ``index`` of ``n``
    owns (the JAX ``local_batch_slice``; B must divide by n)."""
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {n} processes")
    per = global_batch_size // n
    return slice(index * per, (index + 1) * per)


def per_process_seed(seed: int, index: int) -> int:
    """The random batchers' seed of data shard ``index`` under a launch
    (the JAX ``per_process_seed``): spaced 16 apart, so the eval
    batchers' seed + 1 and + 2 never meet a neighbour's."""
    return seed * 1000003 + 16 * index


Group = Union[LocalDataGroup, ProcessDataGroup, None]


def setup(data: int, seq: int = 1, device=None,
          fsdp: bool = False) -> Tuple[torch.device, Group]:
    """(device, group) of a training run on a ``data`` x ``seq`` mesh:
    under a launcher, the process group (joined here) with one shard a
    process (``ProcessDataGroup``); without one, ``device`` (the card
    unless the CPU is asked for) and every shard in this process
    (``LocalDataGroup`` over a ``LocalSeqGroup``). None for the plain run
    (1 x 1 without FSDP)."""
    if world_size() > 1:
        dev = initialize(device, data=data, seq=seq)
        return dev, ProcessDataGroup(data, seq, fsdp)
    dev = resolve_device(device)
    if (data, seq, fsdp) == (1, 1, False):
        return dev, None
    return dev, LocalDataGroup(data, LocalSeqGroup(seq) if seq > 1
                               else None, fsdp)


def setup_serve(mesh: Tuple[int, int], device=None) -> torch.device:
    """The device of a serving run on a (data, model) ``mesh``: under a
    launcher, the process's (its process group joined here, one shard a
    process); without one, ``device`` (the card unless the CPU is asked
    for), every shard then living in this process."""
    if world_size() > 1:
        return initialize(device, mesh=mesh)
    return resolve_device(device)
