"""The serving path's span trace (``repro_torch.serving.spans``) on the
CPU: under a ``torch.profiler`` every iteration of an engine over
``TorchBackend`` gets the whole tree of spans, indexed by the backend's
count of ``execute`` calls; without one the trace keeps nothing; a
forced trace records without a profiler; and tokens, clocks, counters,
logits and the cache come out bit-equal whether the trace is off, forced
or under a profiler. The replays' CUDA-event times are read on the card
only (``tests/test_torch_cuda.py``)."""
import dataclasses
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.energy import H100
from repro_torch.models import tree_tensors
from repro_torch.serving import (EngineConfig, InferenceEngine, SimBackend,
                                 TorchBackend)
from repro_torch.serving import engine as engine_mod
from repro_torch.workloads import PROTOTYPES, generate_requests

ALWAYS = {"engine.iteration", "engine.schedule", "backend.execute",
          "backend.wait", "backend.sync", "engine.complete"}
PARENT = {"engine.iteration": None, "engine.schedule": "engine.iteration",
          "backend.execute": "engine.iteration",
          "engine.complete": "engine.iteration"}


def _engine(n_requests=6, backend=None):
    cfg = get_config("tinyllama-1.1b").reduced()
    backend = backend or TorchBackend(cfg, H100, max_batch=4, cache_len=64,
                                      device="cpu")
    eng = InferenceEngine(cfg, EngineConfig(max_num_seqs=4,
                                            max_batched_tokens=256,
                                            prefill_chunk=64),
                          hardware=H100, backend=backend)
    reqs = generate_requests(PROTOTYPES["normal"], n_requests,
                             base_rate=50.0, seed=0)
    for r in reqs:
        r.prompt_len = min(r.prompt_len, 48)
        r.output_len = min(r.output_len, 6)
    eng.submit(reqs)
    return eng, backend


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _check_tree(spans, rows: int, tokens: int):
    """One iteration's spans, of a plan of ``rows`` decode rows and
    ``tokens`` prefill tokens: the tree, each child inside its parent."""
    by = {s.name: s for s in spans}
    assert len(by) == len(spans)
    ex = by["backend.execute"]
    names = set(ALWAYS)
    if tokens:
        names.add("backend.replay.prefill")
    if rows:
        names |= {"backend.prepare", "backend.replay.decode"}
    assert set(by) == names
    for s in spans:
        assert s.parent == PARENT.get(s.name, "backend.execute"), s
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
        assert s.device_ms is None             # no card: nothing timed
    kids = sorted((s for s in spans if s.parent == "backend.execute"),
                  key=lambda s: s.start_ns)
    order = [s.name for s in kids]
    assert order[0] == "backend.wait" and order[-1] == "backend.sync"
    assert order[1:-1] == [n for n in ("backend.replay.prefill",
                                       "backend.prepare",
                                       "backend.replay.decode")
                           if n in names]
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert by["engine.schedule"].end_ns <= ex.start_ns
    assert ex.end_ns <= by["engine.complete"].start_ns


def test_every_iteration_under_a_profiler_gets_the_tree():
    eng, backend = _engine()
    plans = []
    execute = backend.execute

    def spy(plan, f_mhz):
        plans.append((len(plan.decode), plan.prefill_tokens))
        return execute(plan, f_mhz)
    backend.execute = spy
    with _profiler():
        eng.drain(max_iters=200)
    tr = eng.trace
    assert tr is backend.trace and len(eng.finished) == 6
    by = tr.by_iteration()
    assert sorted(by) == list(range(len(plans))) and tr.executes == len(plans)
    for i, spans in by.items():
        _check_tree(spans, *plans[i])
    # a mixed iteration, a decode-only one and a prefill-only one ran
    kinds = {(r > 0, t > 0) for r, t in plans}
    assert kinds == {(True, True), (True, False), (False, True)}
    assert tr.clock is not None


def test_without_a_profiler_the_trace_holds_nothing():
    eng, backend = _engine()
    eng.drain(max_iters=200)
    assert backend.trace.spans == [] and backend.trace.clock is None
    assert backend.trace.executes == eng.metrics.c.iterations_total > 0


def test_the_trace_follows_the_profiler_and_can_be_forced():
    """Only the iterations that start while a profiler records are
    recorded; a forced trace records without one."""
    eng, backend = _engine()
    eng.drain(max_iters=3)
    with _profiler():
        eng.drain(max_iters=4)
    eng.drain(max_iters=3)
    assert sorted(backend.trace.by_iteration()) == [3, 4, 5, 6]
    eng2, backend2 = _engine()
    backend2.trace.force = True
    eng2.drain(max_iters=5)
    assert sorted(backend2.trace.by_iteration()) == [0, 1, 2, 3, 4]


def test_an_engine_without_a_traced_backend_has_no_trace():
    cfg = get_config("tinyllama-1.1b").reduced()
    eng, _ = _engine(backend=SimBackend(cfg, H100))
    with _profiler():
        eng.drain(max_iters=200)
    assert eng.trace is None and len(eng.finished) == 6


@pytest.fixture
def fixed_wall(monkeypatch):
    """``TorchBackend``'s wall clock made to advance 1 ms a reading from 0
    at each call of the returned function, so that an engine's clock
    repeats exactly from run to run."""
    clock = types.SimpleNamespace(perf_counter_ns=time.perf_counter_ns)

    def restart():
        ticks = iter(range(10**9))
        clock.perf_counter = lambda: 1e-3 * next(ticks)
    monkeypatch.setattr(engine_mod, "time", clock)
    return restart


def _outcome(mode, restart):
    restart()
    eng, backend = _engine()
    if mode == "forced":
        backend.trace.force = True
    if mode == "profiled":
        with _profiler():
            eng.drain(max_iters=200)
    else:
        eng.drain(max_iters=200)
    assert (backend.trace.spans != []) == (mode != "off")
    reqs = sorted(eng.finished, key=lambda r: r.request_id)
    return dict(
        clock=eng.clock, counters=dataclasses.asdict(eng.metrics.c),
        requests=[(r.generated, r.first_scheduled_time, r.first_token_time,
                   r.finish_time) for r in reqs],
        walls=list(backend.decode_wall_s), logits=backend.logits,
        cache=list(tree_tensors(backend.cache)))


def test_tokens_clocks_and_counters_are_bit_equal_on_forced_and_off(
        fixed_wall):
    off = _outcome("off", fixed_wall)
    for mode in ("forced", "profiled"):
        got = _outcome(mode, fixed_wall)
        for k in ("clock", "counters", "walls"):
            assert got[k] == off[k], (mode, k)
        assert got["requests"] == off["requests"], mode
        assert torch.equal(got["logits"], off["logits"]), mode
        for a, b in zip(got["cache"], off["cache"]):
            assert torch.equal(a, b), mode
