"""Host-side request journal: restart recovery for the serving engine (a
copy of ``replicatinggpt_tpu/serve/journal.py``; the same file format).

The engine's device state (the paged KV pool) is disposable: every
request regenerates deterministically from its prompt, sampling params
and rng_seed (per-request sampling streams make the output independent
of the slot and the neighbours). What a crash loses is the *host*
bookkeeping: which requests were in flight. The journal is an
append-only JSONL file: one ``submit`` record when the engine accepts a
request, one ``finish`` record when its terminal ``RequestResult``
exists. After a crash, :meth:`RequestJournal.unfinished` replays the
file and returns the accepted-but-unfinished requests, to requeue into a
fresh engine.

Records are flushed per write (a journal that lags the engine drops the
newest admissions, the window a crash hits). ``fsync_finish=True``
fsyncs every ``finish`` record; ``lock=True`` takes an exclusive
``flock`` at open, so that two processes never append to one journal (a
held lock raises :class:`JournalBusyError` instead of blocking; the
kernel drops the lock when its holder dies). Readers never lock, and
skip the torn final line a crash can leave (and blank lines).

Deadlines are not recovered: they are absolute times on the dead
engine's clock. A recovered request runs without one. The fleet router
(serve/router.py) keeps one journal a replica and requeues a dead
replica's unfinished requests from it, and its own ledger in the same
format.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, TextIO

import numpy as np

from ..utils.jsonl import load_jsonl_if_exists
from .requests import Request, SamplingParams


class JournalBusyError(RuntimeError):
    """Another live process holds this journal's exclusive write lock."""


class RequestJournal:
    """Append-only submit/finish journal (one writer: the engine)."""

    def __init__(self, path: str, fsync_finish: bool = False,
                 lock: bool = False):
        self.path = os.path.abspath(path)
        self.fsync_finish = fsync_finish
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # a previous writer may have died mid-record: end that fragment
        # first, so that it stays one invalid line the reader skips and
        # this writer's first record is not merged into it
        needs_nl = False
        try:
            with open(self.path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                needs_nl = rf.read(1) != b"\n"
        except (OSError, ValueError):
            pass                   # missing or empty file
        self._f: Optional[TextIO] = open(self.path, "a")
        if lock:
            import fcntl
            try:
                fcntl.flock(self._f.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                self._f.close()
                self._f = None
                raise JournalBusyError(
                    f"journal {self.path} is locked by another live "
                    f"process") from e
        if needs_nl:               # after the flock: only the one
            self._f.write("\n")    # legitimate writer repairs the tail
            self._f.flush()

    def _write(self, obj: dict, fsync: bool = False) -> None:
        assert self._f is not None, "journal is closed"
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def record_submit(self, req: Request) -> None:
        sp = req.sampling
        self._write({
            "ev": "submit", "id": req.id,
            "prompt": np.asarray(req.prompt).tolist(),
            "max_new_tokens": int(req.max_new_tokens),
            "rng_seed": int(req.rng_seed),
            "temperature": float(sp.temperature), "top_k": int(sp.top_k),
            "top_p": float(sp.top_p), "greedy": bool(sp.greedy),
            # eos is part of the stop condition: a replay that decodes
            # past it would not give the original's tokens
            **({"eos": int(req.eos_token_id)}
               if req.eos_token_id is not None else {}),
        })

    def record_finish(self, request_id: str, reason: str) -> None:
        self._write({"ev": "finish", "id": request_id, "reason": reason},
                    fsync=self.fsync_finish)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    @staticmethod
    def unfinished(path: str) -> List[Request]:
        """Replay a journal (possibly of a dead engine) and rebuild the
        accepted-but-unfinished requests, in admission order, each once.
        Tolerates a torn final line."""
        submits: Dict[str, Request] = {}
        order: List[str] = []
        for rec in load_jsonl_if_exists(path):
            if rec.get("ev") == "submit":
                rid = rec["id"]
                if rid not in submits:
                    order.append(rid)
                submits[rid] = Request(
                    id=rid, prompt=np.asarray(rec["prompt"], np.int32),
                    max_new_tokens=rec["max_new_tokens"],
                    sampling=SamplingParams(
                        temperature=rec["temperature"],
                        top_k=rec["top_k"], top_p=rec["top_p"],
                        greedy=rec["greedy"]),
                    rng_seed=rec["rng_seed"],
                    eos_token_id=rec.get("eos"))
            elif rec.get("ev") == "finish":
                submits.pop(rec["id"], None)
        # an id can appear in ``order`` twice (finished, then reused by a
        # fresh request): emit each unfinished id once, or the caller
        # would decode it twice
        out, seen = [], set()
        for rid in order:
            if rid in submits and rid not in seen:
                seen.add(rid)
                out.append(submits[rid])
        return out
