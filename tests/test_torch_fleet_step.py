"""Batched fleet-step backend vs the per-event loop: bit-equality gates.

``ServingCluster(step_mode="batched")`` promises trajectories
bit-identical to the default event loop for every supported fleet shape
(see the ``repro_torch.serving.fleet_step`` module docstring for the
equivalence contract and its measure-zero exceptions). These tests drain
the SAME submitted workload through both backends and require exact
equality of: step counts, per-node clocks/frequencies, every metric
counter, every finished request's timeline fields, AGFT policy histories
and LinUCB bank matrices, fleet power-cap accounting, and the public
``summary()`` artifact.

A hypothesis property (skipped without the package, like
``tests/test_property.py``) checks the structural invariant the batched
core's correctness rests on: per-node clocks never move backwards across
event-horizon rounds.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.energy.power_model import A6000_MEASURED
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.fleet_step import BatchedFleetLoop
from repro_torch.workloads import generate_azure_trace

CFG = get_config("llama3-3b")

REQ_FIELDS = ("arrival_time", "prompt_len", "output_len", "prefilled",
              "generated", "finish_time", "first_token_time",
              "first_scheduled_time")
BANK_ARRS = ("_A", "_A_inv", "_b", "_theta", "_n",
             "_reward_sum", "_edp_sum")


def make(n, seed, dur=30.0, rate=0.5, **kw):
    cl = ServingCluster(CFG, n_nodes=n, **kw)
    reqs = generate_azure_trace(dur, base_rate=rate * n, seed=seed)
    cl.submit(reqs)
    return cl


def _counters(eng):
    c = eng.metrics.c
    return dataclasses.asdict(c) if dataclasses.is_dataclass(c) \
        else dict(vars(c))


def _eq(a, b):
    """Exact equality, except NaN == NaN (empty-summary statistics)."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def assert_fleets_identical(a: ServingCluster, b: ServingCluster,
                            sa: int, sb: int) -> None:
    assert sa == sb, f"step counts differ: {sa} vs {sb}"
    for i, (na, nb) in enumerate(zip(a.nodes, b.nodes)):
        ea, eb = na.engine, nb.engine
        assert ea.clock == eb.clock, (i, "clock", ea.clock, eb.clock)
        assert ea.frequency == eb.frequency, (i, "frequency")
        ca, cb = _counters(ea), _counters(eb)
        for k in ca:
            assert ca[k] == cb[k], (i, k, ca[k], cb[k])
        assert len(ea.finished) == len(eb.finished), (i, "finished count")
        # request_ids differ across the two generated traces (global
        # counter), so requests are matched by finish order
        for ra, rb in zip(ea.finished, eb.finished):
            for f in REQ_FIELDS:
                assert getattr(ra, f) == getattr(rb, f), (i, f)
        pa, pb = na.policy, nb.policy
        if pa is None:
            continue
        if hasattr(pa, "history"):
            assert pa.history == pb.history, (i, "history")
        if hasattr(pa, "bank"):
            for name in BANK_ARRS:
                assert np.array_equal(getattr(pa.bank, name),
                                      getattr(pb.bank, name)), (i, name)
            assert pa.round == pb.round
            assert pa.switch_count == pb.switch_count
            assert pa.prev_action == pb.prev_action
    suma = dataclasses.asdict(a.summary())
    sumb = dataclasses.asdict(b.summary())
    for k in suma:
        assert _eq(suma[k], sumb[k]), ("summary", k, suma[k], sumb[k])


def drain_both(n, seed, tick="iteration", dur=30.0, rate=0.5, **kw):
    a = make(n, seed, dur=dur, rate=rate, policy_tick_mode=tick,
             step_mode="event", **kw)
    b = make(n, seed, dur=dur, rate=rate, policy_tick_mode=tick,
             step_mode="batched", **kw)
    sa = a.drain()
    sb = b.drain()
    assert_fleets_identical(a, b, sa, sb)
    return a, b


# ---------------------------------------------------------------------------
# the required grid: 1 / 3 / 10 nodes x both policy-tick modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tick", ["iteration", "tick"])
@pytest.mark.parametrize("n,seed", [(1, 0), (3, 1), (10, 2)])
def test_batched_equals_event_grid(n, seed, tick):
    drain_both(n, seed, tick=tick)


# ---------------------------------------------------------------------------
# fleet shapes that exercise the non-default code paths
# ---------------------------------------------------------------------------

def test_measured_hardware():
    """Nonzero DVFS transition latency/cost (clock-advancing switches)."""
    drain_both(3, 6, hardware=A6000_MEASURED)
    drain_both(2, 7, tick="tick", hardware=A6000_MEASURED)


def test_no_tuners():
    drain_both(3, 8, with_tuners=False)


def test_mixed_policy_fleet_uses_facades():
    """Heterogeneous policies fall off the stacked-AGFT fast path onto
    per-node facades; trajectories must not change."""
    a, b = drain_both(4, 9, policies=["agft", "slo", "ondemand", None])
    assert b._loop.stacked is None
    a, b = drain_both(4, 10, tick="tick",
                      policies=["agft", "slo", "ondemand", None])
    assert b._loop.stacked is None


def test_fleet_policies():
    drain_both(3, 11, fleet_policy="global")
    drain_both(3, 12, fleet_policy="hierarchy",
               policies=["agft", "agft", "agft"])


def test_kv_admission_pressure():
    """High arrival rate: waiting queues, failed admissions, prefix-cache
    eviction churn — the per-node Python fallback path."""
    drain_both(2, 13, rate=4.0)


def test_throughput_engine_config():
    """The mega-fleet benchmark's coarse-block single-chunk config."""
    drain_both(3, 14, engine_cfg=EngineConfig(num_kv_blocks=512,
                                              kv_block_size=128,
                                              prefill_chunk=2048))


# ---------------------------------------------------------------------------
# vectorized classB path: counters + the retained engine fallback
# ---------------------------------------------------------------------------

def test_classb_vectorized_no_engine_steps():
    """The admission fast path runs zero real engine.step() calls, even
    under KV pressure (waiting queues, failed admissions, blocked ticks)."""
    _, b = drain_both(2, 15, rate=4.0)
    loop = b._loop
    assert loop.classb_engine_steps == 0
    assert loop.admitted_requests > 0
    assert loop.classb_fast_steps > 0


def test_classb_engine_fallback_path():
    """classb_path='engine' retains the flush/step/refresh fallback and
    stays bit-identical too (bisection escape hatch)."""
    _, b = drain_both(2, 16, rate=4.0, batched_classb_path="engine")
    loop = b._loop
    assert loop.classb_engine_steps > 0
    assert loop.classb_fast_steps == 0


def test_train_cap_parameter():
    """Any train cap produces the same trajectories (caps only bound
    speculative physics past a horizon cut)."""
    for cap in (1, 8, 256):
        drain_both(3, 17, batched_train_cap=cap)
    with pytest.raises(ValueError, match="train_cap"):
        ServingCluster(CFG, n_nodes=1, step_mode="batched",
                       batched_train_cap=0).drain()


# ---------------------------------------------------------------------------
# max_iters is honored exactly (EventLoop.run parity)
# ---------------------------------------------------------------------------

def test_max_iters_exact_single_node():
    """Truncated single-node runs are bit-identical at every cut — the
    batched loop lands on the exact step count instead of overshooting by
    a round."""
    for cut in (1, 7, 50, 413):
        a = make(1, 20, step_mode="event")
        b = make(1, 20, step_mode="batched")
        sa = a.drain(max_iters=cut)
        sb = b.drain(max_iters=cut)
        assert sa == sb == cut
        assert_fleets_identical(a, b, sa, sb)


def test_max_iters_exact_multi_node():
    """Multi-node: both backends consume exactly min(max_iters, drain)
    steps; a budget covering the drain reproduces the full trajectory."""
    full = make(3, 21, step_mode="batched").drain()
    assert full > 100
    for cut in (1, 5, full // 3, full - 1):
        a = make(3, 21, step_mode="event")
        b = make(3, 21, step_mode="batched")
        sa = a.drain(max_iters=cut)
        sb = b.drain(max_iters=cut)
        assert sa == sb == min(cut, full), cut
    a = make(3, 21, step_mode="event")
    b = make(3, 21, step_mode="batched")
    sa = a.drain(max_iters=full)
    sb = b.drain(max_iters=full)
    assert sa == sb == full
    assert_fleets_identical(a, b, sa, sb)


def test_max_iters_exact_tick_mode():
    for cut in (3, 29):
        a = make(2, 22, step_mode="event", policy_tick_mode="tick")
        b = make(2, 22, step_mode="batched", policy_tick_mode="tick")
        assert a.drain(max_iters=cut) == b.drain(max_iters=cut) == cut


# ---------------------------------------------------------------------------
# unsupported shapes fail loudly, never silently diverge
# ---------------------------------------------------------------------------

def test_bad_step_mode_rejected():
    with pytest.raises(ValueError, match="step_mode"):
        ServingCluster(CFG, n_nodes=1, step_mode="vectorized")


def test_network_model_rejected():
    with pytest.raises(NotImplementedError, match="network"):
        ServingCluster(CFG, n_nodes=2, step_mode="batched",
                       network="datacenter")


def test_mismatched_backend_hardware_rejected():
    """Mixed specs are supported; what stays rejected is an engine whose
    backend DVFS model disagrees with its own ``hardware`` attribute
    (the batched physics would bill the wrong power curve)."""
    cl = ServingCluster(CFG, n_nodes=2, step_mode="batched")
    cl.nodes[1].engine.hardware = A6000_MEASURED
    with pytest.raises(NotImplementedError, match="DVFS spec"):
        cl.drain()


# ---------------------------------------------------------------------------
# heterogeneous hardware: mixed specs drive the same SoA physics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tick", ["iteration", "tick"])
def test_mixed_fleet_bit_identical(tick):
    """3-node mixed fleet (A6000 + H100 + edge) with per-node AGFT loops:
    batched and event backends must agree bit-for-bit, including the
    nonzero-DVFS-transition-cost specs."""
    a, b = drain_both(3, 30, tick=tick,
                      hardware="a6000,h100,edge-orin",
                      policies=["agft", "agft", "agft"])
    assert b._loop.hetero
    assert [sp.name for sp in b._loop.specs] == \
        ["NVIDIA-A6000", "NVIDIA-H100", "EDGE-ORIN"]


def test_mixed_fleet_routers_bit_identical():
    """Routing policy composes with the batched backend on mixed fleets."""
    for router in ("energy", "round-robin"):
        drain_both(3, 31, hardware="h100,l4,a6000", router=router,
                   with_tuners=False)


def test_mixed_fleet_hierarchy_bit_identical():
    """Per-spec waterfill tables + per-node band propagation through the
    coordinator survive the batched fast path."""
    drain_both(3, 32, hardware="a6000,a6000,l4",
               fleet_policy="hierarchy",
               policies=["agft", "agft", "agft"])


def test_fleet_policy_with_tick_mode_rejected():
    cl = ServingCluster(CFG, n_nodes=2, step_mode="batched",
                        fleet_policy="global", policy_tick_mode="tick")
    with pytest.raises(NotImplementedError, match="fleet policy"):
        cl.drain()


def test_oversubscribed_seq_budget_rejected():
    cl = ServingCluster(CFG, n_nodes=1, step_mode="batched",
                        engine_cfg=EngineConfig(max_num_seqs=64,
                                                max_batched_tokens=32))
    with pytest.raises(NotImplementedError, match="max_num_seqs"):
        cl.drain()


# ---------------------------------------------------------------------------
# structural invariant: clocks are monotone across event-horizon rounds
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    _HAVE_HYPOTHESIS = False


def _run_monotone_check(n, seed, tick):
    cl = make(n, seed, dur=20.0, rate=0.8, policy_tick_mode=tick,
              step_mode="batched")
    loop = BatchedFleetLoop(cl.nodes, fleet_policy=None,
                            policy_tick_mode=tick)
    state = {"prev": loop.clock.copy(), "rounds": 0}

    def hook(lp):
        assert np.all(lp.clock >= state["prev"]), \
            "a node clock moved backwards across an event-horizon round"
        state["prev"] = lp.clock.copy()
        state["rounds"] += 1

    loop._round_hook = hook
    loop.run()
    assert state["rounds"] > 0
    assert np.all(loop.clock >= state["prev"] - 0.0)


def _run_classa_soundness(n, seed, tick, cap):
    """classA dispatch is only sound for nodes with NO admission-side
    work: an empty waiting queue, no chunked prefill in progress, and no
    arrival due at or before the node's current clock (every train
    iteration starts strictly before the next arrival horizon)."""
    cl = make(n, seed, dur=20.0, rate=0.8, policy_tick_mode=tick,
              step_mode="batched")
    loop = BatchedFleetLoop(cl.nodes, fleet_policy=None,
                            policy_tick_mode=tick, train_cap=cap)
    orig = loop._step_trains
    seen = {"nodes": 0}

    def checked(idx, cap_):
        assert np.all(loop.W[idx] == 0), "classA node with waiting work"
        assert np.all(loop.P[idx] == 0), "classA node mid-prefill"
        assert np.all(loop.D[idx] > 0), "classA node with no decodes"
        assert np.all(loop.next_arrival[idx] > loop.clock[idx]), \
            "classA node with an arrival already due"
        seen["nodes"] += len(idx)
        return orig(idx, cap_)

    loop._step_trains = checked
    loop.run()
    assert seen["nodes"] > 0


if _HAVE_HYPOTHESIS:
    @settings(max_examples=10, deadline=None)
    @given(n=st.integers(min_value=1, max_value=5),
           seed=st.integers(min_value=0, max_value=2 ** 20),
           tick=st.sampled_from(["iteration", "tick"]))
    def test_clocks_monotone_across_horizons(n, seed, tick):
        _run_monotone_check(n, seed, tick)

    @settings(max_examples=10, deadline=None)
    @given(n=st.integers(min_value=1, max_value=5),
           seed=st.integers(min_value=0, max_value=2 ** 20),
           tick=st.sampled_from(["iteration", "tick"]),
           cap=st.sampled_from([1, 8, 64]))
    def test_classa_nodes_have_no_admission_work(n, seed, tick, cap):
        _run_classa_soundness(n, seed, tick, cap)
else:                                                 # pragma: no cover
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_clocks_monotone_across_horizons():
        pass

    def test_classa_nodes_have_no_admission_work():
        """Deterministic fallback when hypothesis is unavailable: run the
        same invariant check over a fixed sample grid."""
        for n, seed, tick, cap in [(1, 3, "iteration", 64),
                                   (3, 5, "iteration", 8),
                                   (4, 7, "tick", 1),
                                   (5, 11, "tick", 64)]:
            _run_classa_soundness(n, seed, tick, cap)
