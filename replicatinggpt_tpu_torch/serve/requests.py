"""Request/response types for the continuous-batching serving engine.

A copy of ``replicatinggpt_tpu/serve/requests.py`` (host-side types,
no framework code): independent prompts arriving at independent times
with independent sampling params, lengths and deadlines. These types are
the contract between the admission queue (serve/scheduler.py), the page
pool (serve/pages.py) and the engine loop (serve/engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..sample.generate import GenerateConfig


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls — the same knobs as
    ``sample.GenerateConfig`` (temperature/top-k/top-p/greedy), minus
    the length field that belongs to the request."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    greedy: bool = False

    @classmethod
    def from_generate_config(cls, g: GenerateConfig) -> "SamplingParams":
        return cls(temperature=g.temperature, top_k=g.top_k, top_p=g.top_p,
                   greedy=g.greedy)


# Finish reasons (RequestResult.finish_reason). String constants, not an
# enum: they go straight into metrics counter names and JSON summaries.
FINISH_MAX_TOKENS = "max_tokens"        # produced request.max_new_tokens
FINISH_LENGTH_CAP = "length_cap"        # hit the slot's context capacity
                                        # (block_size) before max_new_tokens
FINISH_EOS = "eos"                      # sampled request.eos_token_id (the
                                        # eos token is the stream's last)
FINISH_DEADLINE = "deadline"            # deadline expired (at submit,
                                        # queued, or active)
FINISH_CANCELLED = "cancelled"          # caller cancelled (queued or active)
FINISH_SHED = "shed"                    # dropped by overload shedding
                                        # (faults.watchdog.LoadShedder)
REJECT_QUEUE_FULL = "rejected_queue_full"      # backpressure at submit
REJECT_PROMPT_TOO_LONG = "rejected_prompt_too_long"  # prompt > block_size
REJECT_BAD_REQUEST = "rejected_bad_request"    # empty prompt / bad lengths
# the fleet's terminal reasons (serve/router.py, serve/http.py)
REJECT_FLEET_CAPACITY = "rejected_fleet_capacity"  # the retry ladder ran
                                                   # out of replicas
REJECT_REPLICA_TIMEOUT = "rejected_replica_timeout"  # a replica's submit
                                                     # timed out
REJECT_REPLICA_DOWN = "rejected_replica_down"  # every candidate replica
                                               # unreachable


@dataclass
class Request:
    """One generation request.

    ``deadline`` is an absolute timestamp on the engine's clock
    (``time.monotonic`` unless the engine was given another clock);
    None = no deadline. ``rng_seed`` keys the request's private sampling
    stream (per-slot RNG in the batched sampler), so a request's
    stochastic output is independent of which slot it lands in and of
    its neighbors in the batch.
    """

    id: str
    prompt: np.ndarray                      # (P,) int32 token ids, P >= 1
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    deadline: Optional[float] = None
    rng_seed: int = 0
    #: stop token: generation ends the step this id is sampled (it IS
    #: emitted, as the last token, finish_reason ``eos``); None = run to
    #: max_new_tokens. Must be a valid vocab id — the engine rejects
    #: out-of-range values at submit.
    eos_token_id: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)


@dataclass
class RequestResult:
    """Terminal record for a request — produced exactly once, whether it
    completed, was cancelled, expired, or was rejected at the door."""

    id: str
    tokens: List[int]
    finish_reason: str
    # timings (engine clock, seconds); 0.0 when the phase never ran
    queue_wait_s: float = 0.0               # submit -> admission
    ttft_s: float = 0.0                     # submit -> first new token
    decode_tokens_per_s: float = 0.0        # steady-state decode rate
    total_s: float = 0.0                    # submit -> finish

    @property
    def ok(self) -> bool:
        return self.finish_reason in (FINISH_MAX_TOKENS, FINISH_LENGTH_CAP,
                                      FINISH_EOS)

    def to_dict(self) -> Dict:
        return {"id": self.id, "n_tokens": len(self.tokens),
                "finish_reason": self.finish_reason,
                "queue_wait_s": round(self.queue_wait_s, 6),
                "ttft_s": round(self.ttft_s, 6),
                "decode_tokens_per_s": round(self.decode_tokens_per_s, 2),
                "total_s": round(self.total_s, 6)}
