"""Batchers and device prefetch (a port of
``replicatinggpt_tpu/data/loader.py``).

- ``RandomBatcher``: uniform random (B, T) windows. It draws its offsets
  from the same ``np.random.default_rng(seed).integers(0, len - T, B)``
  stream as the JAX batcher and gathers them with NumPy, so a seed gives
  the JAX package's batches.
- ``SequentialBatcher``: contiguous ``B*T+1`` windows with a wraparound
  cursor; ``shard=(i, n)`` makes it data shard i of n across processes,
  serving the i-th B*T slice of each global (n*B*T)-token window, so the
  processes together see one process's token stream, and the cursor
  (global state, the same on every shard) does not depend on the
  process count.
- ``prefetch``: assembles and copies batches to the device on a
  background thread, ``depth`` ahead. On a CUDA device each batch is
  pinned and copied ``non_blocking`` on a side stream; the consumer's
  stream waits on the copy's event before it reads the batch.

Both batchers have the JAX ``state()`` / ``restore()`` dicts, which a
checkpoint stores as its data cursor.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

Batch = Tuple[np.ndarray, np.ndarray]


def gather_batch(data: np.ndarray, offsets: np.ndarray,
                 T: int) -> Batch:
    """x[b] = data[o_b : o_b+T], y[b] = data[o_b+1 : o_b+T+1]."""
    offsets = np.asarray(offsets, np.int64)
    if offsets.size and (offsets.min() < 0
                         or offsets.max() + T + 1 > len(data)):
        raise ValueError(f"offsets out of range: window [{offsets.min()}, "
                         f"{offsets.max() + T + 1}) exceeds data of "
                         f"{len(data)}")
    win = data[offsets[:, None] + np.arange(T + 1)[None, :]]
    return np.ascontiguousarray(win[:, :-1]), np.ascontiguousarray(win[:, 1:])


class RandomBatcher:
    """Uniform random (B, T) windows."""

    def __init__(self, data: np.ndarray, batch_size: int, block_size: int,
                 seed: int = 0):
        if len(data) <= block_size + 1:
            raise ValueError("corpus shorter than block_size")
        self.data = np.ascontiguousarray(data, np.int32)
        self.B, self.T = batch_size, block_size
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> Batch:
        # exclusive high len-T: the last start is len-T-1, so y still fits
        ix = self.rng.integers(0, len(self.data) - self.T, size=self.B)
        return gather_batch(self.data, ix, self.T)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()

    # random windows have no cursor: the generator's state is the resume
    # state
    def state(self) -> dict:
        return {"bit_generator": self.rng.bit_generator.state}

    def restore(self, state: dict) -> None:
        self.rng.bit_generator.state = state["bit_generator"]


class SequentialBatcher:
    """Contiguous windows with a wraparound cursor (shard i of n: the
    i-th ``B*T`` slice of each global window)."""

    def __init__(self, data: np.ndarray, batch_size: int, block_size: int,
                 shard: Tuple[int, int] = (0, 1)):
        self.shard_index, self.num_shards = shard
        need = self.num_shards * batch_size * block_size + 1
        if len(data) < need:
            raise ValueError(f"corpus of {len(data)} tokens cannot fill one "
                             f"{need}-token window")
        self.data = data
        self.B, self.T = batch_size, block_size
        self.position = 0

    def next_batch(self) -> Batch:
        B, T = self.B, self.T
        stride = self.num_shards * B * T
        if self.position + stride + 1 > len(self.data):
            self.position = 0
        start = self.position + self.shard_index * B * T
        buf = self.data[start:start + B * T + 1]
        self.position += stride
        return (buf[:-1].reshape(B, T).astype(np.int32),
                buf[1:].reshape(B, T).astype(np.int32))

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()

    def state(self) -> dict:
        return {"position": self.position}

    def restore(self, state: dict) -> None:
        self.position = int(state["position"])


def make_batcher(kind: str, data: np.ndarray, batch_size: int,
                 block_size: int, seed: int = 0,
                 shard: Tuple[int, int] = (0, 1)):
    if kind == "random":
        return RandomBatcher(data, batch_size, block_size, seed)
    if kind == "sequential":
        return SequentialBatcher(data, batch_size, block_size, shard=shard)
    raise ValueError(f"unknown sampling kind {kind!r}")


def prefetch(batches: Iterator[Batch], device,
             depth: int = 2) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield the items of ``batches`` (tuples of NumPy arrays) as tensors
    on ``device``, placed by a background thread ``depth`` items ahead;
    an element that is not an array (a batcher's state snapshot) rides
    beside them unchanged. The thread stops when the consumer stops; a
    failure in the producer is raised in the consumer."""
    dev = torch.device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that re-checks stop, so a full queue cannot strand
        # the producer after the consumer has gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _place(b):
        ts = tuple(torch.from_numpy(np.ascontiguousarray(a))
                   if isinstance(a, np.ndarray) else a for a in b)
        if side is None:
            return ts, None
        with torch.cuda.stream(side):
            ts = tuple(t.pin_memory().to(dev, non_blocking=True)
                       if isinstance(t, torch.Tensor) else t for t in ts)
            done = torch.cuda.Event()
            done.record(side)
        return ts, done

    def producer():
        try:
            for b in batches:
                if stop.is_set() or not _put(_place(b)):
                    return
            _put(None)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            ts, done = item
            if done is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                for x in ts:   # the side stream's memory is read on cur
                    if isinstance(x, torch.Tensor):
                        x.record_stream(cur)
            yield ts
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)
