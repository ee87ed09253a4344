"""Driving the program through a cell's traffic, with the harness's own
records around it.

``Recorder`` stands between ``InferenceEngine`` and ``TorchBackend``: it
passes every ``execute`` on and keeps what the iteration was (its decode
rows and their contexts, its prefill forward, the clock it ran at, its
wall and engine time), the slot each decode row writes, the last decode
step's logits and, once armed, the first output of each prefill bucket.
``Loop`` runs the engine one iteration at a time through the program's
own drive loop (``serving.driver.drive``), which calls the policy's
``maybe_act`` on the engine clock's own cadence whatever the slicing, and
sends the closed loop's next requests as earlier ones finish. With a
tracer, ``execute``, the policy's call, each step and each submission are
spans of the profiler (``torch.profiler.record_function``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.driver import EngineNode, drive
from repro_torch.serving.request import Request


@dataclasses.dataclass
class Iteration:
    rows: int                 # decode rows run for requests
    contexts: List[int]       # their cached tokens before the step
    bucket: int               # the prefill forward's padded length, or 0
    f_mhz: float              # the clock it ran at
    wall_s: float             # ``execute``'s wall time
    dt_s: float               # its engine time
    clock_s: float = 0.0      # the engine clock at its end
    host_s: float = 0.0       # the drive call's wall time outside execute
    tokens: int = 0           # output tokens it gave


def _nospan(name):
    return contextlib.nullcontext()


class _Stash:
    """A prefill bucket's graph, whose output the recorder copies the first
    time the bucket runs once armed (before a later replay of the pool
    reuses it)."""

    def __init__(self, graph, rec: "Recorder", n: int):
        self.graph, self.rec, self.n = graph, rec, n

    def __call__(self):
        out = self.graph()
        if self.rec.armed and self.n not in self.rec.prefill_out:
            self.rec.prefill_out[self.n] = out.clone()
        return out

    def __getattr__(self, name):
        return getattr(self.graph, name)


class Recorder:
    def __init__(self, backend):
        self.inner = backend
        self.dvfs = backend.dvfs
        self.engine = None
        self.iterations: List[Iteration] = []
        self.pos: List[np.ndarray] = []
        self.plans = []
        self.span = _nospan
        self.armed = False
        self.prefill_out: Dict[int, torch.Tensor] = {}
        self.logits: Optional[torch.Tensor] = None
        self._logits_copied = True
        for n, g in list(backend.prefill_graphs.items()):
            g = g.graph if isinstance(g, _Stash) else g
            backend.prefill_graphs[n] = _Stash(g, self, n)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, plan, f_mhz: float):
        be = self.inner
        b = be.max_batch
        rows = plan.decode[:b]
        contexts = [r.context_len for r in rows]
        if plan.decode:
            self.pos.append(np.minimum(contexts + [1] * (b - len(rows)),
                                       be.cache_len - 1))
        elif plan.prefill and not self._logits_copied:
            # a prefill replay alone may reuse the pool's memory that holds
            # the last decode step's logits
            self.logits = self.logits.clone()
            self._logits_copied = True
        forwards = be.prefill_steps
        clock = self.engine.clock
        t0 = time.perf_counter()
        with self.span(f"execute#{len(self.iterations)}"):
            dt, energy, power = be.execute(plan, f_mhz)
        wall = time.perf_counter() - t0
        if plan.decode:
            self.logits, self._logits_copied = be.logits, False
        bucket = (be.prefill_lengths[-1] if be.prefill_steps > forwards
                  else 0)
        self.iterations.append(Iteration(
            rows=len(rows), contexts=contexts, bucket=bucket, f_mhz=f_mhz,
            wall_s=wall, dt_s=dt, clock_s=clock + dt))
        self.plans.append(plan)
        return dt, energy, power


class _PolicySpan:
    """The policy, its ``maybe_act`` inside a span."""

    def __init__(self, policy, loop: "Loop"):
        self.policy, self.loop = policy, loop

    def maybe_act(self, engine):
        with self.loop.rec.span("policy"):
            return self.policy.maybe_act(engine)

    def __getattr__(self, name):
        return getattr(self.policy, name)


class Loop:
    """A cell's traffic through the engine. ``jobs`` are ``traffic.Job``s;
    the open loop submits them all at their arrival times, the closed loop
    ``mix["clients"]`` at once and each next one when a request
    finishes."""

    def __init__(self, engine, policy, rec: Recorder, jobs, mix: dict,
                 template_frac: float):
        self.engine, self.policy, self.rec, self.mix = (engine, policy,
                                                        rec, mix)
        rec.engine = engine
        self.node = EngineNode(engine, _PolicySpan(policy, self))
        self.jobs = jobs
        self.frac = template_frac
        self.next_job = 0
        self.requests: List[Request] = []
        self.last_token: Dict[int, float] = {}
        self.tokens_of: Dict[int, int] = {}
        self.gaps: List[float] = []
        self.in_window = False
        self.clock0 = self.clock1 = 0.0
        self.wall0 = self.wall1 = 0.0
        self.iter0 = 0
        self.counters0 = None
        self.finished_seen = 0
        if mix["loop"] == "open":
            self._submit([(j, j.arrival_s) for j in jobs])
            self.next_job = len(jobs)
        else:
            self._submit([(self._take(), 0.0)
                          for _ in range(mix["clients"])])

    def _take(self):
        if self.next_job >= len(self.jobs):
            raise RuntimeError("the closed loop ran out of requests: raise "
                               "the mix's 'requests'")
        j = self.jobs[self.next_job]
        self.next_job += 1
        return j

    def _submit(self, pairs) -> None:
        reqs = [Request(arrival_time=t, prompt_len=j.prompt_len,
                        output_len=j.output_len, template_id=j.template_id,
                        template_frac=self.frac) for j, t in pairs]
        with self.rec.span("submit"):
            self.engine.submit(reqs)
        self.requests.extend(reqs)

    def step(self) -> None:
        eng, rec = self.engine, self.rec
        n_it = len(rec.iterations)
        t0 = time.perf_counter()
        with rec.span("step"):
            drive([self.node], max_iters=1)
        wall = time.perf_counter() - t0
        if len(rec.iterations) > n_it:
            it, plan = rec.iterations[-1], rec.plans[-1]
            rec.plans[-1] = None          # keep no plan beyond its step
            it.host_s = wall - it.wall_s
            t = it.clock_s
            tokens = 0
            for r in plan.decode:
                self._token(r.request_id, t)
                tokens += 1
            for r, _ in plan.prefill:
                if r.first_token_time == t and r.generated == 1:
                    self._token(r.request_id, t)
                    tokens += 1
            it.tokens = tokens
        fin = eng.finished
        if len(fin) > self.finished_seen:
            done = fin[self.finished_seen:]
            self.finished_seen = len(fin)
            if self.mix["loop"] == "closed":
                think = self.mix.get("think_s", 0.0)
                self._submit([(self._take(), r.finish_time + think)
                              for r in done])

    def _token(self, rid: int, t: float) -> None:
        last = self.last_token.get(rid)
        if last is not None and self.in_window:
            self.gaps.append(t - last)
        self.last_token[rid] = t
        self.tokens_of[rid] = self.tokens_of.get(rid, 0) + 1

    def warmup(self, iterations: int) -> None:
        while len(self.rec.iterations) < iterations:
            self.step()

    def window(self, seconds: float, tracer=None) -> None:
        """Run for ``seconds`` of wall time; with a tracer, trace the slice
        it names."""
        eng, rec = self.engine, self.rec
        c = eng.metrics.c
        self.counters0 = (c.generation_tokens_total, c.energy_joules_total,
                          c.requests_finished_total)
        self.iter0 = len(rec.iterations)
        self.decode_walls0 = len(rec.inner.decode_wall_s)
        self.in_window = True
        rec.armed = True
        self.clock0 = eng.clock
        self.wall0 = time.perf_counter()
        end = self.wall0 + seconds
        if tracer is not None:
            tracer.plan(self.wall0, seconds)
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if tracer is not None:
                tracer.tick(now, self)
            self.step()
        if tracer is not None:
            tracer.finish(self)
        self.wall1 = time.perf_counter()
        self.clock1 = eng.clock
        self.in_window = False
        rec.armed = False

    # ------------------------------------------------------------------
    def window_iterations(self) -> List[Iteration]:
        return self.rec.iterations[self.iter0:]

    def window_requests(self) -> List[Request]:
        return [r for r in self.requests
                if self.clock0 <= r.arrival_time <= self.clock1]
