"""The port's baseline policies (``repro_torch.policies.{fixed,rules}``)
against the JAX package's numpy originals: each policy's decision history
on a seeded ``SimBackend`` run equals ``repro``'s bit for bit, and the
registry and behaviour tests of ``tests/test_policies.py`` for ``static``,
``oracle``, ``ondemand``, ``slo`` and ``snap_to_grid`` pass on the port."""
import pytest

import repro.policies as jpolicies
from repro.configs import get_config as jax_get_config
from repro.energy import A6000 as JAX_A6000
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.workloads import PROTOTYPES as JAX_PROTOTYPES
from repro.workloads import generate_requests as jax_generate_requests
from repro_torch.configs import get_config
from repro_torch.energy import A6000
from repro_torch.policies import (OndemandPolicy, OracleFixedPolicy,
                                  PowerPolicy, SLOAwareLatencyPolicy,
                                  StaticPolicy, available_policies,
                                  get_policy, register_policy, snap_to_grid)
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")
CORE_POLICIES = ("agft", "static", "ondemand", "slo", "oracle")


def make_engine(frequency=None):
    return InferenceEngine(CFG, EngineConfig(),
                           initial_frequency=frequency or A6000.f_max)


def trace(n=80, rate=3.0, seed=21, workload="normal"):
    return generate_requests(PROTOTYPES[workload], n, base_rate=rate,
                             seed=seed)


# ---------------------------------------------------------------------------
# Parity with repro.policies
# ---------------------------------------------------------------------------

def _run(engine, requests, policy):
    engine.submit(requests)
    engine.drain(policy=policy)
    return engine


@pytest.mark.parametrize("name,n,rate,seed", [
    ("static", 120, 3.0, 5), ("oracle", 120, 3.0, 5),
    ("ondemand", 60, 0.5, 9), ("slo", 200, 3.0, 3),
    ("slo-ttft", 200, 3.0, 31)])
def test_decision_history_matches_repro(name, n, rate, seed):
    """The same seeded trace through each package's engine on its
    ``SimBackend``: equal decision histories (every window's record, the
    frequency decided included), energy, final clock and the policy's own
    pinned clock or calibrated budgets."""
    jp = jpolicies.get_policy(name, hardware=JAX_A6000)
    jeng = _run(JaxInferenceEngine(jax_get_config("llama3-3b"),
                                   JaxEngineConfig(),
                                   initial_frequency=JAX_A6000.f_max),
                jax_generate_requests(JAX_PROTOTYPES["normal"], n,
                                      base_rate=rate, seed=seed), jp)
    p = get_policy(name, hardware=A6000)
    eng = _run(make_engine(), trace(n, rate=rate, seed=seed), p)
    assert type(p).__name__ == type(jp).__name__
    assert len(eng.finished) == len(jeng.finished) == n
    assert len(p.history) > 0 and p.history == jp.history
    assert eng.metrics.c.energy_joules_total == \
        jeng.metrics.c.energy_joules_total
    assert eng.frequency == jeng.frequency
    for attr in ("frequency_mhz", "tpot_slo_s", "ttft_slo_s", "mode"):
        assert getattr(p, attr, None) == getattr(jp, attr, None), attr


# ---------------------------------------------------------------------------
# Registry (tests/test_policies.py::TestRegistry)
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_all_core_policies_construct(self):
        for name in CORE_POLICIES:
            p = get_policy(name, hardware=A6000)
            assert isinstance(p, PowerPolicy)      # structural protocol

    def test_available_lists_core_policies(self):
        avail = available_policies()
        for name in CORE_POLICIES + ("observer", "slo-ttft"):
            assert name in avail

    def test_unknown_name_raises_with_choices(self):
        with pytest.raises(KeyError, match="agft"):
            get_policy("does-not-exist")

    def test_duplicate_registration_rejected(self):
        with pytest.raises(ValueError):
            register_policy("static")(StaticPolicy)

    def test_kwargs_reach_constructor(self):
        p = get_policy("static", frequency_mhz=1200.0)
        assert p.frequency_mhz == 1200.0
        t = get_policy("agft", strategy="thompson")
        assert t.cfg.strategy == "thompson"


# ---------------------------------------------------------------------------
# Baseline behaviour (tests/test_policies.py::TestBaselines)
# ---------------------------------------------------------------------------

class TestBaselines:
    def _energy(self, policy, n=120, rate=3.0, seed=5):
        eng = make_engine()
        eng.submit(trace(n, rate=rate, seed=seed))
        eng.drain(policy=policy)
        assert len(eng.finished) == n
        return eng.metrics.c.energy_joules_total, eng

    def test_static_below_fmax_saves_energy_when_slack_exists(self):
        e_max, _ = self._energy(None)
        e_static, eng = self._energy(StaticPolicy(A6000,
                                                  frequency_mhz=1200.0))
        assert eng.frequency == 1200.0
        assert e_static < e_max

    def test_oracle_picks_interior_frequency_and_saves(self):
        e_max, _ = self._energy(None)
        oracle = get_policy("oracle")
        assert isinstance(oracle, OracleFixedPolicy)
        e_oracle, _ = self._energy(oracle)
        assert A6000.f_min < oracle.frequency_mhz < A6000.f_max
        assert e_oracle < e_max

    def test_ondemand_downclocks_under_slack(self):
        policy = OndemandPolicy(A6000)
        eng = make_engine()
        eng.submit(trace(60, rate=0.5, seed=9))   # sparse arrivals
        eng.drain(policy=policy)
        freqs = [h["freq"] for h in policy.history]
        assert len(eng.finished) == 60
        assert min(freqs) < A6000.f_max           # it did scale down

    def test_slo_policy_walks_down_but_recovers(self):
        policy = get_policy("slo")
        assert isinstance(policy, SLOAwareLatencyPolicy)
        eng = make_engine()
        eng.submit(trace(200, seed=3))
        eng.drain(policy=policy)
        freqs = [h["freq"] for h in policy.history]
        assert min(freqs) < A6000.f_max           # saved energy somewhere
        assert policy.tpot_slo_s is not None      # calibrated its budget

    def test_slo_ttft_mode_calibrates(self):
        policy = get_policy("slo-ttft")
        assert policy.mode == "ttft"
        eng = make_engine()
        eng.submit(trace(200, seed=31))
        eng.drain(policy=policy)
        assert policy.ttft_slo_s is not None and policy.tpot_slo_s is None

    def test_snap_to_grid(self):
        assert snap_to_grid(1203.0, A6000) == 1200.0
        assert snap_to_grid(1e9, A6000) == A6000.f_max
        assert snap_to_grid(-5.0, A6000) == A6000.f_min
