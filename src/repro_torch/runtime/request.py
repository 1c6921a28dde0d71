"""Request lifecycle objects shared by the engine and the simulator."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    REJECTED = "rejected"
    CANCELLED = "cancelled"


@dataclass
class Request:
    request_id: int
    model: str
    prompt_tokens: int
    max_new_tokens: int
    arrival_time: float
    prompt_ids: Optional[object] = None      # jax/np array when real tokens
    eos_id: Optional[int] = None             # None disables EOS stopping
    # prefix-cache opt-out (DESIGN.md §11): True lets the engine reuse /
    # index this prompt's KV.  Only requests with real ``prompt_ids`` ever
    # participate — synthetic prompts are silently cache-cold.
    cache: bool = True
    phase: Phase = Phase.QUEUED
    # --- progress -------------------------------------------------------
    generated: int = 0
    output_ids: List[int] = field(default_factory=list)
    eos_seen: bool = False
    # --- latency bookkeeping ---------------------------------------------
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    token_times: List[float] = field(default_factory=list)

    @property
    def context_length(self) -> int:
        return self.prompt_tokens + self.generated

    def tbt_samples(self) -> List[float]:
        """Time-between-tokens gaps (the paper's decode latency metric)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    @property
    def done(self) -> bool:
        return self.eos_seen or self.generated >= self.max_new_tokens
