"""Public request surface of the serving API (the vLLM-shaped half).

``SamplingParams`` travels with a request through admission, the legacy
per-token loop and the fused decode megastep — the engine lowers it to
padded per-slot device arrays (see ``core.sampling.sample_from_logits``).
``RequestOutput`` is what the engine emits back: one event per request per
engine step that produced tokens for it, carrying both the delta and the
cumulative generation, plus a ``finish_reason`` once the request ends.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

FINISH_STOP = "stop"          # hit a stop token id
FINISH_LENGTH = "length"      # generated max_tokens
FINISH_CAPACITY = "capacity"  # force-finished at block-table capacity
FINISH_ABORT = "aborted"      # caller cancelled via engine.abort()
FINISH_DEADLINE = "deadline"  # per-request deadline expired
FINISH_ERROR = "error"        # quarantined: poisoned dispatch / NaN row
FINISH_SHED = "shed"          # load-shed from a full waiting queue


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.

    temperature: 0.0 => greedy argmax; > 0 scales logits before sampling.
    top_k:       keep only the k highest logits (0 disables).
    top_p:       nucleus sampling — keep the smallest set of tokens whose
                 probability mass reaches top_p (1.0 disables).
    seed:        per-request PRNG stream seed; None derives a stream from
                 the engine seed and the request id (still deterministic,
                 but tied to the engine instance).
    stop:        token ids that end the generation; the matched token is
                 included in the output and finish_reason is "stop".
    max_tokens:  generation budget; finish_reason "length" when reached.
    ttft_deadline_ms: wall-clock budget (from arrival) for the FIRST
                 token; a request still token-less past it finishes with
                 finish_reason "deadline" (None disables).
    deadline_ms: total wall-clock budget (from arrival) for the whole
                 request; enforced by the scheduler every step, whether
                 the request is waiting, mid-prefill, or decoding —
                 finish_reason "deadline", partial output kept (None
                 disables).
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: List[int] = field(default_factory=list)
    max_tokens: int = 32
    ttft_deadline_ms: Optional[float] = None
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        for name in ("ttft_deadline_ms", "deadline_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0 (or None)")


@dataclass
class RequestOutput:
    """One streamed event for a request.

    ``new_token_ids`` is the delta since the previous event for the same
    request; ``token_ids`` is the cumulative generation so far.  ``text``
    / ``new_text`` are filled only when the engine was given a
    detokenizer.  ``finish_reason`` is None while the request is running,
    else one of "stop" | "length" | "capacity" | "aborted" | "deadline"
    | "error" | "shed".
    """
    request_id: int
    prompt_token_ids: List[int]
    token_ids: List[int]
    new_token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[str] = None
    text: str = ""
    new_text: str = ""
