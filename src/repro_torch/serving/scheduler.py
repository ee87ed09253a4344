"""Continuous-batching scheduler (vLLM-style, chunked prefill).

Every engine iteration builds a mixed batch: each RUNNING decode sequence
contributes one token; WAITING/prefilling sequences contribute prompt chunks
up to the per-iteration token budget. Finished sequences release their
blocks immediately to admit waiting work — the "come-and-go" behaviour
(Orca/vLLM) whose interleaving is exactly what makes phase identification
from raw power telemetry hard (paper Fig. 1) and motivates the fingerprint.

Hot-path structures are sized for fleet-scale traces: ``waiting`` is a
deque (O(1) FCFS admission pops and preemption re-queues, no per-iteration
list rebuild when the batch is full), and ``running`` is an
insertion-ordered dict keyed by ``request_id`` — O(1) removal on the
completion and preemption paths, with iteration order identical to the old
append-only list. ``complete_iteration`` touches only the iteration's
batch participants (the only requests whose ``generated`` advanced),
instead of scanning every running sequence.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Tuple

from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import Request, RequestState


@dataclasses.dataclass
class BatchPlan:
    """Work selected for one iteration."""
    prefill: List[Tuple[Request, int]]      # (request, new prompt tokens)
    decode: List[Request]                   # one token each

    @property
    def prefill_tokens(self) -> int:
        return sum(n for _, n in self.prefill)

    @property
    def decode_seqs(self) -> int:
        return len(self.decode)

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_seqs

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class ContinuousBatchingScheduler:
    def __init__(self, kv: PagedKVCache, *,
                 max_num_seqs: int = 64,
                 max_batched_tokens: int = 2048,
                 prefill_chunk: int = 512):
        self.kv = kv
        self.max_num_seqs = max_num_seqs
        #: the configured ceiling ``set_admission_cap`` clamps against
        self._base_max_seqs = max_num_seqs
        self.max_batched_tokens = max_batched_tokens
        self.prefill_chunk = prefill_chunk
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}       # request_id -> Request
        # requests whose first output token was produced since the last
        # ``pop_first_token_events`` call — the engine drains this to
        # account TTFT at assignment time (no float-equality replay)
        self._first_token_events: List[Request] = []
        # deadline-expired requests shed at admission; the flag keeps the
        # no-deadline hot path free of per-request deadline checks
        self.dropped: List[Request] = []
        self._has_deadlines = False

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        req.state = RequestState.WAITING
        if req.deadline_s is not None:
            self._has_deadlines = True
        self.waiting.append(req)

    def set_admission_cap(self, cap) -> None:
        """Optional second control knob (dual-knob policies): clamp
        concurrent-sequence admission to ``min(cap, configured
        max_num_seqs)``; ``None`` restores the configured ceiling.
        Already-running sequences are never evicted — the cap throttles
        future admission only, so it takes effect as sequences finish.
        Admission always reads ``max_num_seqs`` live (both the event loop
        and the batched fleet path drive the real ``_admit``), so a
        policy may retune the cap every window."""
        base = self._base_max_seqs
        self.max_num_seqs = (base if cap is None
                             else max(1, min(base, int(cap))))

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def num_running(self) -> int:
        return len(self.running)

    # ------------------------------------------------------------------
    def _admit(self, now: float) -> List[Request]:
        """FCFS admission while seq and KV budgets allow; returns the
        requests admitted this call, in admission order (the batched
        fleet backend drives admission directly off this list).

        A request that does not fit the KV budget is skipped (not
        head-of-line blocking) and keeps its queue position relative to the
        other non-admitted requests.

        Requests carrying a ``deadline_s`` that has already expired are
        shed here (``self.dropped``) instead of admitted — graceful load
        shedding for overloaded or post-crash queues. Traces without
        deadlines never pay for the check.
        """
        admitted: List[Request] = []
        if not self.waiting or (len(self.running) >= self.max_num_seqs
                                and not self._has_deadlines):
            return admitted
        skipped: List[Request] = []
        for _ in range(len(self.waiting)):
            if (len(self.running) >= self.max_num_seqs
                    and not self._has_deadlines):
                break
            req = self.waiting.popleft()
            if (req.deadline_s is not None
                    and now - req.arrival_time > req.deadline_s):
                req.state = RequestState.DROPPED
                self.dropped.append(req)
                continue
            if len(self.running) >= self.max_num_seqs:
                skipped.append(req)
                continue
            total = req.prompt_len + req.output_len
            if self.kv.try_allocate(req, total):
                req.state = RequestState.RUNNING
                if req.first_scheduled_time is None:
                    req.first_scheduled_time = now
                # prefix-cache hits skip that prefill work
                req.prefilled = req.cached_tokens
                self.running[req.request_id] = req
                admitted.append(req)
            else:
                skipped.append(req)
        self.waiting.extendleft(reversed(skipped))
        return admitted

    def _preempt_lowest_priority(self) -> bool:
        """Free blocks by kicking the most recent running request back to
        the queue (vLLM recompute-style preemption)."""
        for req in reversed(self.running.values()):
            if req.is_prefilling:
                continue
            del self.running[req.request_id]
            self.kv.free(req, preempted=True)
            req.state = RequestState.WAITING
            req.prefilled = 0
            req.generated = 0
            req.cached_tokens = 0
            self.waiting.appendleft(req)
            return True
        return False

    # ------------------------------------------------------------------
    def schedule(self, now: float) -> BatchPlan:
        self._admit(now)
        budget = self.max_batched_tokens
        decode: List[Request] = []
        prefill: List[Tuple[Request, int]] = []
        prefilling: List[Request] = []
        # single pass over running: decodes admitted first (latency-critical,
        # one token each, in running order while budget lasts); prefill
        # candidates collected for the chunk pass below. The comparisons
        # inline ``is_prefilling`` — this is the hottest loop in the engine.
        for req in self.running.values():
            if req.prefilled < req.prompt_len:
                prefilling.append(req)
            elif budget > 0:
                decode.append(req)
                budget -= 1
        # then chunked prefill
        for req in prefilling:
            if budget <= 0:
                break
            chunk = min(req.prompt_len - req.prefilled, self.prefill_chunk,
                        budget)
            prefill.append((req, chunk))
            budget -= chunk
        return BatchPlan(prefill=prefill, decode=decode)

    # ------------------------------------------------------------------
    def pop_first_token_events(self) -> List[Request]:
        """Requests that produced their first token since the last call."""
        events, self._first_token_events = self._first_token_events, []
        return events

    def complete_iteration(self, plan: BatchPlan, now: float
                           ) -> List[Request]:
        """Apply the iteration's effects; returns newly finished requests.

        Only the plan's participants can newly finish (``generated`` only
        advances through a plan), so completion is O(batch), not
        O(running).
        """
        finished: List[Request] = []
        for req, chunk in plan.prefill:
            req.prefilled += chunk
            if req.prefilled >= req.prompt_len:
                # prompt done -> first output token is produced this iter
                req.generated += 1
                if req.first_token_time is None:
                    req.first_token_time = now
                    self._first_token_events.append(req)
                self.kv.register_prefix(req)
                if req.generated >= req.output_len:
                    finished.append(req)
        for req in plan.decode:
            req.generated += 1
            if req.generated >= req.output_len:
                finished.append(req)
        for req in finished:
            req.state = RequestState.FINISHED
            req.finish_time = now
            del self.running[req.request_id]
            self.kv.free(req)
        return finished
