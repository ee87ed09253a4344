"""Request lifecycle for the continuous-batching engine.

Privacy contract (paper §2.2/§3.2): the AGFT tuner must never read
``prompt_len``/``output_len``/``template_id`` of an individual request —
those fields exist only so the *simulation* can execute the request. The
tuner consumes exclusively the aggregate metrics exported by
``serving.metrics``.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

_ids = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"       # prefilling or decoding
    PREEMPTED = "preempted"
    FINISHED = "finished"
    DROPPED = "dropped"       # shed: deadline expired or retries exhausted


@dataclasses.dataclass(slots=True)
class Request:
    arrival_time: float
    prompt_len: int                  # hidden from the tuner
    output_len: int                  # hidden from the tuner
    template_id: int = 0             # prefix-cache identity (hidden)
    template_frac: float = 0.9       # fraction of prompt shared w/ template
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    #: load-shedding budget: a request still WAITING ``deadline_s`` after
    #: its arrival is dropped at admission instead of ballooning TTFT
    #: (None = never sheds, the historical behavior)
    deadline_s: Optional[float] = None
    #: crash re-route attempts consumed (fault injection; see
    #: ``repro.serving.faults`` — bounded by the model's retry budget)
    retries: int = 0

    # execution progress
    state: RequestState = RequestState.WAITING
    prefilled: int = 0               # prompt tokens processed (incl. cached)
    generated: int = 0
    cached_tokens: int = 0           # prompt tokens served from prefix cache

    # timing
    #: when the routing path handed the request to its engine (None on the
    #: direct-submit path); TTFT/E2E stay measured from ``arrival_time``,
    #: so routing delay shows up in latency instead of vanishing
    delivery_time: Optional[float] = None
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def net_delay(self) -> Optional[float]:
        """Routing-path delay (delivery - arrival); None if direct."""
        if self.delivery_time is None:
            return None
        return self.delivery_time - self.arrival_time

    # ------------------------------------------------------------------
    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefilled

    @property
    def is_prefilling(self) -> bool:
        return self.prefilled < self.prompt_len

    @property
    def done(self) -> bool:
        return self.generated >= self.output_len

    @property
    def context_len(self) -> int:
        return self.prefilled + self.generated

    # latency metrics -----------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.output_len <= 1:
            return 0.0
        return ((self.finish_time - self.first_token_time)
                / (self.output_len - 1))

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time
