"""Admission control for the serving engine (a copy of
``replicatinggpt_tpu/serve/scheduler.py``, host-side code).

A bounded FIFO queue with backpressure: ``submit`` either enqueues or
rejects-with-reason immediately (never blocks, never grows without
bound — the "heavy traffic" failure mode is a queue that silently eats
RAM while latency compounds). Each engine step, ``admit`` hands over as
many queued requests as there are free pool slots, in arrival order,
dropping queued requests whose deadline already expired (no point
prefilling work that is already late).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from .requests import (FINISH_DEADLINE, REJECT_BAD_REQUEST,
                       REJECT_PROMPT_TOO_LONG, REJECT_QUEUE_FULL, Request)


class Scheduler:
    """Bounded FIFO admission queue + per-step admission decisions."""

    def __init__(self, max_queue: int, block_size: int,
                 clock: Callable[[], float] = time.monotonic):
        assert max_queue >= 1, max_queue
        self.max_queue = max_queue
        self.block_size = block_size
        self.clock = clock
        self._queue: Deque[Tuple[Request, float]] = deque()  # (req, t_submit)

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def depth(self) -> int:
        return len(self._queue)

    def contains(self, request_id: str) -> bool:
        """Whether ``request_id`` is still queued (submit-time duplicate
        check; O(queue), which is bounded by max_queue)."""
        return any(req.id == request_id for req, _ in self._queue)

    def ids(self) -> List[str]:
        """Queued request ids in arrival order (the engine's
        ``in_flight_ids``)."""
        return [req.id for req, _ in self._queue]

    def peek(self) -> Optional[Tuple[Request, float]]:
        """The queue head without popping it: the windowed engine asks
        whether this step could admit (strict FIFO, as in ``admit``)."""
        return self._queue[0] if self._queue else None

    def submit(self, req: Request) -> Optional[str]:
        """Enqueue ``req``; returns None on acceptance or a rejection
        reason (backpressure / validation) — the caller must surface
        rejections to the client instead of retrying blindly."""
        if req.prompt.size < 1 or req.max_new_tokens < 1:
            return REJECT_BAD_REQUEST
        if req.prompt.size > self.block_size:
            return REJECT_PROMPT_TOO_LONG
        if req.deadline is not None and self.clock() >= req.deadline:
            # already dead on arrival: queueing it would burn a queue
            # slot and a prefill on work nobody can use
            return FINISH_DEADLINE
        if len(self._queue) >= self.max_queue:
            return REJECT_QUEUE_FULL
        self._queue.append((req, self.clock()))
        return None

    def shed(self, n: int) -> List[Tuple[Request, float]]:
        """Drop up to ``n`` requests from the queue TAIL (newest first:
        the oldest are closest to service and fresh arrivals are the
        cheapest to turn away). ``faults.watchdog.LoadShedder`` drives
        the policy."""
        out: List[Tuple[Request, float]] = []
        while self._queue and len(out) < n:
            out.append(self._queue.pop())
        return out

    def cancel(self, request_id: str) -> bool:
        """Remove a still-queued request; True if it was found (an
        already-admitted request is the engine's to cancel)."""
        for i, (req, _) in enumerate(self._queue):
            if req.id == request_id:
                del self._queue[i]
                return True
        return False

    def admit(self, n_free: int, now: Optional[float] = None,
              fits: Optional[Callable[[Request], bool]] = None
              ) -> Tuple[List[Tuple[Request, float]],
                         List[Tuple[Request, float, str]]]:
        """Pop up to ``n_free`` admissible requests (arrival order).

        ``fits`` is the engine's resource gate beyond free slots (the
        paged pool's free-page check): a head that does not fit BLOCKS
        the queue rather than being skipped — strict FIFO, so a large
        request cannot be starved by a stream of small ones slipping
        past it. Returns (admitted, dropped): admitted as
        (request, t_submit) pairs; dropped as (request, t_submit,
        reason) for queued requests whose deadline expired before a
        slot freed up.
        """
        if now is None:
            now = self.clock()
        admitted: List[Tuple[Request, float]] = []
        dropped: List[Tuple[Request, float, str]] = []
        while self._queue and len(admitted) < n_free:
            req, t_submit = self._queue[0]
            if req.deadline is not None and now >= req.deadline:
                self._queue.popleft()
                dropped.append((req, t_submit, FINISH_DEADLINE))
                continue
            if fits is not None and not fits(req):
                break
            self._queue.popleft()
            admitted.append((req, t_submit))
        return admitted, dropped

    def drain_expired(self, now: Optional[float] = None
                      ) -> List[Tuple[Request, float, str]]:
        """Drop every queued request whose deadline has passed (called
        even when no slot is free, so expired work never occupies queue
        capacity)."""
        if now is None:
            now = self.clock()
        dropped, keep = [], deque()
        for req, t_submit in self._queue:
            if req.deadline is not None and now >= req.deadline:
                dropped.append((req, t_submit, FINISH_DEADLINE))
            else:
                keep.append((req, t_submit))
        self._queue = keep
        return dropped
