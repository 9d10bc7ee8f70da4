"""Torn-tail-tolerant JSONL reading (a copy of
``replicatinggpt_tpu/utils/jsonl.py``): the one reader of the request
journals (serve/journal.py) and of the journals the fleet router replays
after a replica dies (serve/router.py).

Blank lines are skipped, and so is a line that does not parse as JSON:
the torn final record a crash leaves mid-write. Every record stands on
its own, so a recovery reader that drops one bad line keeps the rest.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List


def iter_jsonl(path: str) -> Iterator[dict]:
    """Each parseable JSON object in ``path``, skipping blank and torn
    lines."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue              # torn record (crash mid-write)


def load_jsonl(path: str) -> List[dict]:
    """A whole JSONL file, read tolerantly (see :func:`iter_jsonl`)."""
    return list(iter_jsonl(path))


def load_jsonl_if_exists(path: str) -> List[dict]:
    """A journal that was never created (its writer died before the first
    record) is an empty history, not an error."""
    if not os.path.exists(path):
        return []
    return load_jsonl(path)
