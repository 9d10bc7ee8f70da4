"""Checkpoint save and restore of the whole training state, verified (a
port of ``replicatinggpt_tpu/train/checkpoint.py`` onto ``torch.save``
in place of orbax).

A step is the resume state of ``TrainState.state_dict()`` (weights,
AdamW moments and count, both dropout generators' states, step) and the
data cursor (the batcher's ``state()``):

    <dir>/<step>/state.pt        torch.save of the flat arrays (CPU)
    <dir>/<step>/data.json       the batcher's state, when one is given
    <dir>/manifest-<step>.json   {"step", "arrays": {name: {crc32, dtype,
                                  shape, finite}}}

- **Atomic finalize.** A step is written into ``<step>.tmp/``, its
  files and the directory fsynced, then renamed to ``<step>/``: a
  half-written step is never listed. The manifest follows the payload,
  written to a temporary name and renamed.
- **Integrity manifest.** A crc32 over each array's bytes, its dtype,
  shape and a finite bit, taken from the arrays handed to ``torch.save``.
  Restore reads the payload on the CPU, checks it against the manifest
  and only then copies it into the caller's state, on the caller's
  device: a crc mismatch, an array non-finite at save, an unreadable
  manifest or payload, or a step with no manifest (every save here
  writes one, so a step without one is a save that never finished)
  raises :class:`CorruptCheckpointError` naming the step and the array.
- **Fallback restore.** ``restore_latest`` walks the steps newest first
  past corrupt ones (``recovery['ckpt_fallbacks']``). None means no step
  exists; steps that exist but all fail raise.
- **Transient I/O.** Save and restore retry ``OSError`` with exponential
  backoff (``save_retries``, ``restore_retries``).
- ``max_to_keep`` steps are kept; older steps and their manifests go.

Under a launch (``torchrun``) every rank calls ``save``: the state's
arrays are gathered one at a time (``TrainState.state_items``: the full
leaves whatever the shards, every rank's dropout streams), rank 0 copying
each to the host and the others dropping it, with the batchers' cursors
(one, when the ranks' agree, as sequential windows' global cursor does;
else each rank's), rank 0 writes the step, and all ranks wait for it at
a barrier. Every rank restores (reading the same files, so the same
fallbacks) and keeps its own shards and cursor.

Fault seams (``faults/inject.py``): ``ckpt/save`` and ``ckpt/restore``
(``io``), ``ckpt/finalize`` (``corrupt``, ``truncate``,
``drop_manifest`` after a completed save).

``timings`` holds the last save's and restore's seconds by phase (the
device-to-host copy, the crc32 pass, the write with its fsyncs, the
read) and bytes.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..faults.inject import active, corrupt_step_dir, fire
from .state import TrainState

STATE_FILE = "state.pt"
DATA_FILE = "data.json"
#: the first retry's wait; each later one doubles it
BACKOFF_S = 0.05


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step failed verification (checksum mismatch,
    non-finite arrays at save, a missing or unreadable manifest, or a
    payload that does not load)."""


def _array_bytes(t: torch.Tensor) -> memoryview:
    """The bytes of a CPU tensor in memory order (any dtype)."""
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _fingerprint(arrays: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """Per-array integrity record of CPU tensors: crc32 over the bytes,
    dtype (numpy's name: ``float32``), shape, and for floating arrays
    whether every value is finite (JAX ``_state_fingerprint``'s record)."""
    out = {}
    for name, t in arrays.items():
        out[name] = {
            "crc32": zlib.crc32(_array_bytes(t)),
            "dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape),
            "finite": (bool(torch.isfinite(t).all())
                       if t.is_floating_point() else True),
        }
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_synced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 retries: int = 2):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep}: keep at least "
                             f"the newest step")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.retries = retries
        #: recovery counts the supervisor merges into its Metrics
        self.recovery: Dict[str, int] = {
            "ckpt_fallbacks": 0, "save_retries": 0, "restore_retries": 0}
        self.timings: Dict[str, Dict[str, float]] = {}
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------ helpers

    def _with_retries(self, fn, what: str, counter: str):
        """``fn()``, retrying OSError with exponential backoff; the last
        failure propagates."""
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except OSError as e:
                if attempt == self.retries:
                    raise
                self.recovery[counter] += 1
                delay = BACKOFF_S * (2 ** attempt)
                print(f"checkpoint {what}: transient I/O failure "
                      f"({e}); retry {attempt + 1}/{self.retries} "
                      f"in {delay:.2f}s", flush=True)
                time.sleep(delay)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest-{step}.json")

    def _write_manifest(self, step: int, record: dict) -> None:
        tmp = self._manifest_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "arrays": record}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path(step))

    def _load_manifest(self, step: int) -> dict:
        path = self._manifest_path(step)
        if not os.path.exists(path):
            raise CorruptCheckpointError(
                f"checkpoint step {step} is corrupt: no integrity manifest "
                f"(the save did not finish)")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step} is corrupt: unreadable integrity "
                f"manifest ({e})") from e

    def _prune(self) -> None:
        """Drop steps past ``max_to_keep`` and manifests with no step."""
        steps = self.all_steps()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        keep = {f"manifest-{s}.json" for s in self.all_steps()}
        try:
            for name in os.listdir(self.directory):
                if (name.startswith("manifest-") and name.endswith(".json")
                        and name not in keep):
                    os.unlink(os.path.join(self.directory, name))
        except OSError:
            print("checkpoint: manifest pruning failed (non-fatal); "
                  "stale manifests may accumulate", flush=True)

    @staticmethod
    def _verify(step: int, manifest: dict,
                arrays: Dict[str, torch.Tensor]) -> None:
        """Diff the payload read back against the save-time manifest."""
        saved = manifest["arrays"]
        for key, rec in saved.items():
            if not rec.get("finite", True):
                raise CorruptCheckpointError(
                    f"checkpoint step {step} is corrupt: array {key} was "
                    f"non-finite at save time (NaN-poisoned state is not "
                    f"a valid rollback target)")
        if set(arrays) != set(saved):
            raise CorruptCheckpointError(
                f"checkpoint step {step} is corrupt: manifest lists "
                f"{len(saved)} arrays, the payload holds {len(arrays)}")
        for key, rec in saved.items():
            t = arrays[key]
            if (str(t.dtype).removeprefix("torch.") != rec["dtype"]
                    or list(t.shape) != rec["shape"]
                    or zlib.crc32(_array_bytes(t)) != rec["crc32"]):
                raise CorruptCheckpointError(
                    f"checkpoint step {step} is corrupt: array {key} "
                    f"checksum mismatch (bit rot or partial write)")

    # ---------------------------------------------------------------- API

    def all_steps(self) -> List[int]:
        """Finalized steps, oldest first (``<step>.tmp`` is not one)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, batcher: Any = None) -> int:
        """Write ``state`` (and ``batcher.state()``) as step
        ``state.step``; a step already on disk is left as it is."""
        step = int(state.step)
        if step in self.all_steps():
            return step
        t0 = time.perf_counter()
        launched = dist.is_initialized()
        writer = not launched or dist.get_rank() == 0
        # the other ranks take part in each leaf's gather and drop it
        arrays = {k: v.detach().cpu() for k, v in state.state_items()
                  if writer}
        cursor = None if batcher is None else batcher.state()
        if launched and cursor is not None:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, cursor)
            cursor = every[0] if all(c == every[0] for c in every) else {
                "ranks": every}
        if not writer:
            dist.barrier()
            return step
        t1 = time.perf_counter()
        record = _fingerprint(arrays)
        t2 = time.perf_counter()
        data = None if cursor is None else json.dumps(cursor)

        def _do_save():
            f = fire("ckpt/save", index=step)
            if f is not None and f.kind == "io":
                raise OSError(f"injected transient save failure "
                              f"(step {step})")
            tmp = self._step_dir(step) + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write_synced(os.path.join(tmp, STATE_FILE),
                          lambda fh: torch.save(arrays, fh))
            if data is not None:
                _write_synced(os.path.join(tmp, DATA_FILE),
                              lambda fh: fh.write(data.encode()))
            _fsync_dir(tmp)
            os.replace(tmp, self._step_dir(step))
            _fsync_dir(self.directory)

        self._with_retries(_do_save, "save", "save_retries")
        self._write_manifest(step, record)
        self._prune()
        t3 = time.perf_counter()
        self.timings["save"] = {
            "bytes": sum(t.numel() * t.element_size()
                         for t in arrays.values()),
            "copy_s": t1 - t0, "crc_s": t2 - t1, "write_s": t3 - t2,
            "total_s": t3 - t0}
        f = fire("ckpt/finalize", index=step)
        if f is not None:
            # chaos only: break the finalized step as bit rot or a crashed
            # writer would
            if f.kind == "drop_manifest":
                try:
                    os.unlink(self._manifest_path(step))
                except OSError:
                    pass
            else:
                plan = active()
                corrupt_step_dir(self.directory, step, f.kind,
                                 plan.rng("ckpt/finalize"))
        if launched:
            dist.barrier()
        return step

    def restore(self, step: int, state: TrainState,
                batcher: Any = None) -> TrainState:
        """Verify step ``step`` and copy it into ``state`` (in place, on
        the state's devices; returned) and ``batcher``. Raises
        :class:`CorruptCheckpointError` when the step fails verification,
        ValueError when it does not fit the template (another model), and
        the OSError once the retries are spent."""
        manifest = self._load_manifest(step)
        step_dir = self._step_dir(step)
        t0 = time.perf_counter()

        def _do_restore():
            f = fire("ckpt/restore", index=step)
            if f is not None and f.kind == "io":
                raise OSError(f"injected transient restore failure "
                              f"(step {step})")
            with open(os.path.join(step_dir, STATE_FILE), "rb") as fh:
                arrays = torch.load(fh, map_location="cpu",
                                    weights_only=True)
            data = None
            path = os.path.join(step_dir, DATA_FILE)
            if batcher is not None and os.path.exists(path):
                with open(path) as fh:
                    data = json.load(fh)
            return arrays, data

        try:
            arrays, data = self._with_retries(_do_restore, "restore",
                                              "restore_retries")
        except OSError:
            raise
        except Exception as e:
            # the payload did not load although the step was finalized:
            # its bytes are corrupt or partial
            raise CorruptCheckpointError(
                f"checkpoint step {step} is corrupt: restore failed "
                f"({type(e).__name__}: {e})") from e
        if not isinstance(arrays, dict):
            raise CorruptCheckpointError(
                f"checkpoint step {step} is corrupt: payload is a "
                f"{type(arrays).__name__}, not named arrays")
        t1 = time.perf_counter()
        self._verify(step, manifest, arrays)
        t2 = time.perf_counter()
        state.load_state_dict(arrays)
        if batcher is not None and data is not None:
            if "ranks" in data:
                ranks = data["ranks"]
                n = dist.get_world_size() if dist.is_initialized() else 1
                if len(ranks) != n:
                    raise ValueError(
                        f"checkpoint step {step} holds the data cursors of "
                        f"{len(ranks)} processes (random windows drawn per "
                        f"process); resume it on {len(ranks)}")
                data = ranks[dist.get_rank() if n > 1 else 0]
            batcher.restore(data)
        t3 = time.perf_counter()
        self.timings["restore"] = {
            "bytes": sum(t.numel() * t.element_size()
                         for t in arrays.values()),
            "read_s": t1 - t0, "crc_s": t2 - t1, "copy_s": t3 - t2,
            "total_s": t3 - t0}
        return state

    def restore_latest(self, state: TrainState,
                       batcher: Any = None) -> Optional[TrainState]:
        """The newest step that verifies, restored into ``state``, falling
        back past corrupt or unreadable steps (counted in
        ``recovery['ckpt_fallbacks']``). None only when no step exists;
        steps that exist but all fail raise :class:`CorruptCheckpointError`
        (a resume that read that as "no checkpoint" would restart from
        step 0 over the run it was asked to continue)."""
        steps = self.all_steps()[::-1]
        if not steps:
            return None
        last_err: Optional[Exception] = None
        for i, step in enumerate(steps):
            try:
                return self.restore(step, state, batcher)
            except (CorruptCheckpointError, OSError) as e:
                last_err = e
                self.recovery["ckpt_fallbacks"] += 1
                nxt = steps[i + 1] if i + 1 < len(steps) else None
                print(f"checkpoint restore_latest: {e} — "
                      + (f"falling back to step {nxt}" if nxt is not None
                         else "no earlier step to fall back to"),
                      flush=True)
        raise CorruptCheckpointError(
            f"no restorable checkpoint under {self.directory}: all "
            f"{len(steps)} step(s) {sorted(steps)} failed verification "
            f"(last: {last_err})") from last_err
