"""Process set-up for runs across processes.

The counterpart of ``replicatinggpt_tpu/parallel/distributed.py`` for
``torchrun``: one process per card. Without a launcher (``WORLD_SIZE``
unset or 1) the run is one process and every shard lives in it.

- Training with a seq axis: each process holds one shard of every
  sequence (``parallel.mesh.ProcessSeqGroup``; ``LocalSeqGroup`` in one
  process). Data parallelism in training is not in this port yet, so
  ``WORLD_SIZE`` must equal ``--sp``.
- Serving on a (data, model) mesh: each process holds one shard
  (``parallel.serve_group.ProcessServeGroup``; ``LocalServeGroup`` in one
  process), so ``WORLD_SIZE`` must equal data x model.

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
from .mesh import LocalSeqGroup, ProcessSeqGroup


def world_size() -> int:
    """Processes of this launch (``torchrun``'s ``WORLD_SIZE``; 1 without
    a launcher)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(device=None, sp: Optional[int] = None,
               mesh: Optional[Tuple[int, int]] = None) -> torch.device:
    """Join the launch's process group (``torchrun``'s ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    NCCL on the card ``cuda:LOCAL_RANK``, or gloo when ``device`` is the
    CPU. Returns the process's device. Raises when ``WORLD_SIZE`` is not
    ``sp`` (data parallelism in training is ROADMAP.md queue A item 11),
    or not data x model for a serving ``mesh``."""
    n = world_size()
    if sp is not None and n != sp:
        raise ValueError(f"{n} processes for --sp {sp}: every process is "
                         f"one sequence shard here (data parallelism across "
                         f"processes is ROADMAP.md queue A item 11)")
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


def setup(seq: int, device=None) -> Tuple[torch.device,
                                         Union[LocalSeqGroup,
                                               ProcessSeqGroup, None]]:
    """(device, seq group) of a run with a seq axis of ``seq``: under a
    launcher, the process group (joined here) with one shard a process;
    without one, ``device`` (the card unless the CPU is asked for) and all
    shards in this process (None when ``seq`` is 1)."""
    if world_size() > 1:
        dev = initialize(device, sp=seq)
        return dev, ProcessSeqGroup()
    dev = resolve_device(device)
    return dev, (LocalSeqGroup(seq) if seq > 1 else None)


def setup_serve(mesh: Tuple[int, int], device=None) -> torch.device:
    """The device of a serving run on a (data, model) ``mesh``: under a
    launcher, the process's (its process group joined here, one shard a
    process); without one, ``device`` (the card unless the CPU is asked
    for), every shard then living in this process."""
    if world_size() > 1:
        return initialize(device, mesh=mesh)
    return resolve_device(device)
