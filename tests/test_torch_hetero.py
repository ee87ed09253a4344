"""Heterogeneous-hardware fleet: registry, parsing, routing, bands.

Covers the hardware registry promoted into ``repro_torch.energy``
(:func:`resolve_hardware` / :func:`parse_fleet_hardware`), the
index-generated frequency grid (fractional steps must keep ``f_max`` on
the grid), throughput-normalized least-loaded placement, deterministic
energy-aware routing, per-spec band coordination, and the
hardware-keyed oracle-sweep cache migration.
"""
import dataclasses

import pytest

from benchmarks.common import _migrate_oracle_cache, _oracle_key
from repro_torch.configs import get_config
from repro_torch.energy import (A6000, EDGE_ORIN, H100, HARDWARE, L4,
                          parse_fleet_hardware, resolve_hardware)
from repro_torch.policies import get_policy
from repro_torch.policies.hierarchy import BandCoordinator, full_busy_power_w
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.serving.cluster import (EnergyAwareRouter, RoundRobinRouter,
                                   ServingCluster, make_router,
                                   route_least_loaded)
from repro_torch.serving.request import Request
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")


def _engine(hw, frequency=None):
    return InferenceEngine(CFG, EngineConfig(), hardware=hw,
                           initial_frequency=frequency or hw.f_max)


# ---------------------------------------------------------------------------
# registry + fleet-spec parsing
# ---------------------------------------------------------------------------

def test_registry_names_resolve():
    for name, spec in HARDWARE.items():
        assert resolve_hardware(name) is spec
        assert resolve_hardware(name.upper()) is spec
        assert resolve_hardware(spec) is spec


def test_registry_unknown_name():
    with pytest.raises(ValueError, match="a6000"):
        resolve_hardware("rtx-9090")


def test_parse_fleet_spec_string():
    specs = parse_fleet_hardware("a6000,h100:2,l4")
    assert [s.name for s in specs] == \
        ["NVIDIA-A6000", "NVIDIA-H100", "NVIDIA-H100", "NVIDIA-L4"]


def test_parse_fleet_broadcast_and_count_mismatch():
    assert [s.name for s in parse_fleet_hardware("h100", 3)] == \
        ["NVIDIA-H100"] * 3
    assert parse_fleet_hardware(A6000, 2) == [A6000, A6000]
    with pytest.raises(ValueError, match="3"):
        parse_fleet_hardware("a6000,l4", 3)


def test_new_specs_are_distinct_hardware():
    """The calibrated tiers must be genuinely different machines: power
    envelopes, frequency ranges, and DVFS switching costs all ordered the
    way the real parts are."""
    assert H100.p_dyn_compute > A6000.p_dyn_compute > L4.p_dyn_compute \
        > EDGE_ORIN.p_dyn_compute
    assert H100.peak_flops > A6000.peak_flops > L4.peak_flops \
        > EDGE_ORIN.peak_flops
    assert EDGE_ORIN.f_max < A6000.f_max < L4.f_max
    assert H100.dvfs_transition_cost_j > L4.dvfs_transition_cost_j \
        > EDGE_ORIN.dvfs_transition_cost_j
    assert len({s.frequencies()[0] for s in (H100, L4, EDGE_ORIN)}) == 3


# ---------------------------------------------------------------------------
# frequency grid: index-generated, no float-accumulation drift
# ---------------------------------------------------------------------------

def test_fractional_step_grid_keeps_f_max():
    """EDGE_ORIN's 33.15 MHz step is not exactly representable; repeated
    addition drifts and (on wide grids) drops f_max entirely. The grid is
    generated by index so the envelope endpoints always survive."""
    grid = EDGE_ORIN.frequencies()
    assert grid[0] == EDGE_ORIN.f_min
    assert EDGE_ORIN.f_max in grid
    assert len(grid) == 31


def test_wide_fractional_grid_regression():
    """3000-step grid at 7.7 MHz: the accumulating generator lost ~0.008
    MHz by the top of the range and dropped the final point."""
    sp = dataclasses.replace(A6000, f_min=100.0, f_max=23200.0, f_step=7.7)
    grid = sp.frequencies()
    assert len(grid) == 3001
    assert grid[0] == 100.0
    assert grid[-1] == 23200.0
    assert sp.f_max in grid


def test_a6000_grid_unchanged():
    """Integer-step grids (the golden-pinned A6000) are bitwise what the
    old generator produced."""
    grid = A6000.frequencies()
    assert grid[0] == A6000.f_min and grid[-1] == A6000.f_max
    assert grid == [A6000.f_min + 15.0 * i for i in range(len(grid))]


# ---------------------------------------------------------------------------
# routers
# ---------------------------------------------------------------------------

def _req(prompt_len=256, deadline=None):
    return Request(arrival_time=0.0, prompt_len=prompt_len, output_len=64,
                   deadline_s=deadline)


def test_least_loaded_normalizes_by_throughput():
    """5 queued on an H100 is less busy than 3 queued on an L4; raw counts
    would say the opposite."""
    fast, slow = _engine(H100), _engine(L4)
    fast.submit([_req() for _ in range(5)])
    slow.submit([_req() for _ in range(3)])
    assert route_least_loaded([fast, slow], _req()) == 0
    assert route_least_loaded([slow, fast], _req()) == 1


def test_least_loaded_homogeneous_ties_unchanged():
    a, b = _engine(A6000), _engine(A6000)
    assert route_least_loaded([a, b], _req()) == 0
    b.submit([_req()])
    assert route_least_loaded([a, b], _req()) == 0
    a.submit([_req(), _req()])
    assert route_least_loaded([a, b], _req()) == 1


def test_energy_router_prefers_efficient_node():
    """Both idle and within the TTFT tier: the H100's joules-per-token is
    below the A6000's, so placement concentrates there."""
    r = EnergyAwareRouter()
    assert r([_engine(A6000), _engine(H100)], _req()) == 1
    assert r([_engine(H100), _engine(A6000)], _req()) == 0


def test_energy_router_tie_breaks_to_lowest_index():
    """Identical nodes -> identical jpt -> deterministic index 0, every
    call (strict-< scan, no dict-order or float-noise dependence)."""
    engines = [_engine(A6000) for _ in range(4)]
    r = EnergyAwareRouter()
    assert all(r(engines, _req()) == 0 for _ in range(10))


def test_energy_router_slo_fallback():
    """When no node meets the tier, degrade to least estimated wait
    instead of still chasing joules."""
    fast, slow = _engine(H100), _engine(EDGE_ORIN)
    r = EnergyAwareRouter(default_ttft_slo_s=1e-12)
    assert r([slow, fast], _req()) == 1


def test_make_router_registry():
    assert make_router("least-loaded") is route_least_loaded
    assert isinstance(make_router("round-robin"), RoundRobinRouter)
    assert isinstance(make_router("ENERGY"), EnergyAwareRouter)
    r1, r2 = make_router("round-robin"), make_router("round-robin")
    assert r1 is not r2        # factories: no state shared across clusters
    with pytest.raises(ValueError, match="router"):
        make_router("random")


def test_round_robin_cycles():
    engines = [_engine(A6000) for _ in range(3)]
    r = RoundRobinRouter()
    assert [r(engines, _req()) for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]


# ---------------------------------------------------------------------------
# mixed-fleet band coordination
# ---------------------------------------------------------------------------

def test_coordinator_per_spec_inversion():
    """Mixed fleet under one cap: each node's f_hi must fit its OWN
    full-busy power curve, and per-node band edges respect per-spec
    envelopes."""
    specs = [A6000, H100, EDGE_ORIN]
    coord = BandCoordinator(specs, power_cap_w=700.0)
    engines = [_engine(sp) for sp in specs]
    bands = coord.initial_bands(engines)
    assert bands is not None and len(bands) == 3
    share = 700.0 / 3
    for (lo, hi), sp in zip(bands, specs):
        assert sp.f_min <= lo <= hi <= sp.f_max
        assert hi in sp.frequencies()
        # conservative one-sided cap: full-busy draw at f_hi fits the
        # node's water-filled share (floors + uniform weights at t=0)
        if hi > sp.f_min:
            assert full_busy_power_w(sp, hi) <= 700.0
    # the edge part's whole envelope fits its share; the H100's does not
    assert full_busy_power_w(EDGE_ORIN, bands[2][1]) <= share
    assert bands[1][1] < H100.f_max


def test_coordinator_refreshes_specs_from_engines():
    """Constructor spec list is only a default: ``act`` re-reads each
    engine's hardware, so placement changes flow into the water-fill."""
    coord = BandCoordinator(A6000, power_cap_w=500.0)
    engines = [_engine(A6000), _engine(L4)]
    bands = coord.initial_bands(engines)
    assert coord._node_specs == [A6000, L4]
    (lo0, hi0), (lo1, hi1) = bands
    assert hi0 <= A6000.f_max and hi1 <= L4.f_max
    assert lo1 == L4.f_min


def test_cluster_propagates_per_node_bands():
    """End to end: hierarchy fleet policy on a mixed fleet clamps each
    node policy's band inside its own spec envelope."""
    hw_list = parse_fleet_hardware("a6000,h100,l4")
    cl = ServingCluster(CFG, n_nodes=3, hardware=hw_list,
                        fleet_policy=get_policy("hierarchy",
                                                hardware=hw_list,
                                                power_cap_w=800.0),
                        policies=["agft", "agft", "agft"])
    cl.submit(generate_requests(PROTOTYPES["normal"], 40,
                                base_rate=2.0, seed=5))
    cl.drain()
    for node, sp in zip(cl.nodes, parse_fleet_hardware("a6000,h100,l4")):
        assert node.engine.hardware is sp
        band = getattr(node.policy, "band", None)
        if band is not None:
            lo, hi = band
            assert sp.f_min <= lo <= hi <= sp.f_max


# ---------------------------------------------------------------------------
# oracle-sweep cache: hardware-keyed, legacy entries migrated
# ---------------------------------------------------------------------------

def test_oracle_cache_key_includes_hardware():
    k1 = _oracle_key("normal", 150, 3.0, 1, A6000)
    k2 = _oracle_key("normal", 150, 3.0, 1, H100)
    assert k1 != k2
    assert k1.endswith("|NVIDIA-A6000") and k2.endswith("|NVIDIA-H100")


def test_oracle_cache_migration():
    cache = {"normal|n150|r3.0|s1": 1170.0,
             "long_context|n150|r3.0|s1|NVIDIA-H100": 900.0}
    out = _migrate_oracle_cache(cache)
    assert out == {"normal|n150|r3.0|s1|NVIDIA-A6000": 1170.0,
                   "long_context|n150|r3.0|s1|NVIDIA-H100": 900.0}
    # idempotent: migrating a migrated cache is the identity
    assert _migrate_oracle_cache(out) == out
