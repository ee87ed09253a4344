"""Serving driver: run the continuous-batching engine — or an N-node
cluster — under a workload with any registered power policy (or none).

  python -m repro_torch.launch.serve --arch llama3-3b --workload normal \
      --requests 2000 --policy agft
  python -m repro_torch.launch.serve --arch llama3-3b --workload azure \
      --duration 3600 --policy slo
  python -m repro_torch.launch.serve --workload normal --policy none \
      --frequency 1200
  python -m repro_torch.launch.serve --nodes 4 --policy agft       # per-node loops
  python -m repro_torch.launch.serve --nodes 4 --fleet-policy global   # one global
  # hierarchical power capping: the coordinator water-fills an 800 W
  # cluster budget into per-node frequency bands on FLEET_TICK while
  # per-node AGFT loops fine-tune inside them
  python -m repro_torch.launch.serve --nodes 4 --fleet-policy hierarchy \
      --power-cap-w 800 --policy agft
  # realistic routing path (WAN-ish ~50 ms delivery delay) + per-node
  # policies deciding on wall-clock POLICY_TICK events instead of
  # iteration boundaries
  python -m repro_torch.launch.serve --nodes 2 --policy agft \
      --network-model wan --policy-tick-mode tick
  # mixed-hardware fleet with energy-aware placement: requests land on
  # the node whose marginal joules-per-token is lowest among nodes that
  # can still meet the request's TTFT tier
  python -m repro_torch.launch.serve --nodes 4 --hardware a6000,h100:2,l4 \
      --router energy --policy agft
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.energy import HARDWARE, parse_fleet_hardware, resolve_hardware
from repro_torch.policies import available_policies, get_policy
from repro_torch.serving import (FAULT_PRESETS, NETWORK_PRESETS,
                           POLICY_TICK_MODES, EngineConfig,
                           InferenceEngine, NetworkModel)
from repro_torch.serving.cluster import ROUTERS, ServingCluster
from repro_torch.workloads import (PROTOTYPES, generate_azure_trace,
                             generate_requests)


def build_engine(arch: str, hardware_name: str = "a6000",
                 engine_cfg: EngineConfig = None) -> InferenceEngine:
    hw = resolve_hardware(hardware_name)
    return InferenceEngine(get_config(arch), engine_cfg or EngineConfig(),
                           hardware=hw, initial_frequency=hw.f_max)


def summarize(engine: InferenceEngine, tuner=None) -> dict:
    fin = engine.finished
    c = engine.metrics.c
    ttft = float(np.mean([r.ttft for r in fin])) if fin else 0.0
    tpot = float(np.mean([r.tpot for r in fin
                          if r.tpot is not None])) if fin else 0.0
    e2e = float(np.mean([r.e2e for r in fin])) if fin else 0.0
    out = {
        "finished": len(fin),
        "energy_j": c.energy_joules_total,
        "wall_s": engine.clock,
        "busy_s": c.busy_seconds_total,
        "ttft_s": ttft,
        "tpot_s": tpot,
        "e2e_s": e2e,
        "edp": c.energy_joules_total * tpot,
        "prefix_hit_rate": engine.kv.stats.hit_rate,
        "preemptions": engine.kv.stats.preemptions,
        "avg_power_w": (c.energy_joules_total / engine.clock
                        if engine.clock else 0.0),
    }
    if tuner is not None:
        out["policy"] = type(tuner).__name__
        if hasattr(tuner, "bank"):   # AGFT-specific learning state
            out["tuner"] = {
                "rounds": tuner.round,
                "converged_round": tuner.converged_round,
                "reopened": tuner.convergence.reopened,
                "pruned": len(tuner.pruner.permanently_pruned),
                "refinements": len(tuner.refiner.log),
                "arms": len(tuner.bank.arms),
            }
        elif getattr(tuner, "history", None):
            acted = [h for h in tuner.history if h.get("acted")]
            out["tuner"] = {"windows": len(tuner.history),
                            "actions": len(acted)}
    return out


def _generate(args):
    if args.workload == "azure":
        dur = args.duration or 3600.0
        return generate_azure_trace(dur, base_rate=args.rate,
                                    seed=args.seed)
    return generate_requests(PROTOTYPES[args.workload], args.requests,
                             base_rate=args.rate, seed=args.seed)


def _node_policies(args, hw_list):
    if args.policy == "none":
        return [None] * args.nodes
    kw = ({"frequency_mhz": args.frequency}
          if args.policy in ("static", "oracle") and args.frequency
          else {})
    return [get_policy(args.policy, hardware=hw, **kw)
            for hw in hw_list]


def _serve_cluster(args) -> dict:
    """N-node fleet: per-node copies of --policy (each resolved against
    its node's hardware spec), one --fleet-policy controller for the
    whole cluster, or BOTH for hierarchical control (a band coordinator
    on FLEET_TICK + node-local loops inside the bands)."""
    hw_list = parse_fleet_hardware(args.hardware, args.nodes)
    hetero = any(hw != hw_list[0] for hw in hw_list)
    fleet_hw = hw_list if hetero else hw_list[0]
    fleet = None
    if args.fleet_policy != "none":
        try:
            fleet = get_policy(args.fleet_policy, hardware=fleet_hw,
                               **({"power_cap_w": args.power_cap_w}
                                  if args.power_cap_w else {}))
        except TypeError:
            # controller without a cap parameter (e.g. "global"): attach
            # the cap as a metering-only attribute — the event loop still
            # accounts violations against it
            fleet = get_policy(args.fleet_policy, hardware=fleet_hw)
            fleet.power_cap_w = args.power_cap_w
    if fleet is None:
        policies = _node_policies(args, hw_list)
    elif getattr(fleet, "coordinates_bands", False):
        # hierarchical: node loops fine-tune inside the coordinator's
        # bands (default to the paper's per-node AGFT)
        if args.policy == "none":
            args.policy = "agft"
        policies = _node_policies(args, hw_list)
    elif getattr(fleet, "observe_only", False):
        # metering-only fleet policy: per-node --policy stays in charge
        policies = _node_policies(args, hw_list)
    else:
        policies = None     # single-frequency controllers actuate alone
    network = None
    if args.network_model != "none":
        network = NetworkModel.from_spec(args.network_model,
                                         seed=args.network_seed)
    cl = ServingCluster(get_config(args.arch), n_nodes=args.nodes,
                        hardware=hw_list, policies=policies,
                        fleet_policy=fleet, router=args.router,
                        network=network,
                        faults=(args.faults if args.faults != "none"
                                else None),
                        fault_seed=args.fault_seed,
                        policy_tick_mode=args.policy_tick_mode)
    if args.policy == "none" and args.frequency:
        for e in cl.engines:
            e.set_frequency(args.frequency)
    cl.submit(_generate(args))
    steps = cl.drain()
    s = cl.summary()
    out = {
        "nodes": args.nodes,
        "hardware": s.node_hardware,
        "router": args.router,
        "network_model": args.network_model,
        "policy_tick_mode": args.policy_tick_mode,
        "fleet_policy": args.fleet_policy,
        "policy": (args.policy if fleet is None
                   or getattr(fleet, "coordinates_bands", False)
                   or getattr(fleet, "observe_only", False) else None),
        "finished": s.finished,
        "energy_j": s.energy_j,
        "ttft_s": s.mean_ttft_s,
        "tpot_s": s.mean_tpot_s,
        "edp": s.edp,
        "node_frequencies": s.node_frequencies,
        "node_energy_j": s.node_energy_j,
        "engine_steps": steps,
    }
    if s.energy_by_tier and len(s.energy_by_tier) > 1:
        out["energy_by_tier"] = s.energy_by_tier
        out["finished_by_tier"] = s.finished_by_tier
    if s.power_cap_w is not None:
        out["power_cap_w"] = s.power_cap_w
        out["cap_violation_s"] = s.cap_violation_s
        out["metered_s"] = s.metered_s
        out["mean_fleet_power_w"] = s.mean_fleet_power_w
        out["peak_fleet_power_w"] = s.peak_fleet_power_w
    if s.mean_net_delay_s is not None:
        out["mean_net_delay_s"] = s.mean_net_delay_s
        out["max_net_delay_s"] = s.max_net_delay_s
    out["submitted"] = s.submitted
    out["dropped_total"] = s.dropped_total
    out["completion_rate"] = s.completion_rate
    if args.faults != "none":
        out["faults"] = args.faults
        out["fault_seed"] = args.fault_seed
        out["fault_counters"] = s.fault_counters
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-3b")
    ap.add_argument("--hardware", default="a6000",
                    help="hardware spec name "
                         f"({', '.join(sorted(HARDWARE))}) or, with "
                         "--nodes N, a mixed-fleet spec string like "
                         "'a6000,h100:2,l4' (name[:count] entries; counts "
                         "must sum to N; one bare name broadcasts)")
    ap.add_argument("--router", default="least-loaded",
                    choices=sorted(ROUTERS),
                    help="cluster request placement: 'least-loaded' "
                         "(throughput-normalized queue depth), 'energy' "
                         "(lowest marginal joules-per-token meeting the "
                         "request's TTFT tier), 'round-robin', 'length'")
    ap.add_argument("--workload", default="normal",
                    choices=list(PROTOTYPES) + ["azure"])
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="azure trace duration (sim seconds)")
    ap.add_argument("--rate", type=float, default=3.0)
    ap.add_argument("--policy", "--tuner", dest="policy", default="agft",
                    choices=available_policies(scope="node") + ["none"])
    ap.add_argument("--frequency", type=float, default=0.0,
                    help="fixed frequency for --policy none/static "
                         "(0 = f_max / the static default)")
    ap.add_argument("--nodes", type=int, default=1,
                    help="serve through an N-node ServingCluster")
    ap.add_argument("--fleet-policy", default="none",
                    choices=available_policies(scope="fleet") + ["none"],
                    help="fleet-scope controller: 'global' (one frequency "
                         "for all nodes, overrides per-node --policy) or "
                         "'hierarchy' (per-node bands; --policy keeps "
                         "running inside them)")
    ap.add_argument("--power-cap-w", type=float, default=0.0,
                    help="cluster power budget in watts for --fleet-policy "
                         "hierarchy/hierarchy-uniform (0 = uncapped); with "
                         "other fleet policies it only meters violations")
    ap.add_argument("--network-model", default="none",
                    help="routing-path model for --nodes >= 2: 'none' "
                         "(instant placement), a preset "
                         f"({', '.join(sorted(NETWORK_PRESETS))}), or "
                         "fixed:<ms> for a constant total routing delay")
    ap.add_argument("--network-seed", type=int, default=0,
                    help="seed of the network model's hop-latency stream")
    ap.add_argument("--faults", default="none",
                    help="fault-injection preset "
                         f"({', '.join(sorted(FAULT_PRESETS))}) or clause "
                         "spec like 'crash:mttf=60,mttr=5;telemetry:"
                         "drop=0.3' (see repro_torch.serving.faults)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the per-node fault RNG streams")
    ap.add_argument("--policy-tick-mode", default="iteration",
                    choices=list(POLICY_TICK_MODES),
                    help="when per-node policies decide: 'iteration' "
                         "(engine-clock gating at iteration boundaries; "
                         "golden-pinned default) or 'tick' (wall-clock "
                         "POLICY_TICK events, windows cut at tick time)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.fleet_policy != "none" and args.nodes < 2:
        ap.error("--fleet-policy needs --nodes >= 2")
    # network routing, fault injection and pure policy ticks live in the
    # cluster/event-loop path; a single node becomes a 1-node cluster
    if (args.nodes > 1 or args.network_model != "none"
            or args.faults != "none"
            or args.policy_tick_mode != "iteration"):
        summary = _serve_cluster(args)
    else:
        eng = build_engine(args.arch, args.hardware)
        eng.submit(_generate(args))
        tuner = None
        if args.policy != "none":
            kw = ({"frequency_mhz": args.frequency}
                  if args.policy in ("static", "oracle") and args.frequency
                  else {})
            tuner = get_policy(args.policy,
                               hardware=resolve_hardware(args.hardware),
                               **kw)
        elif args.frequency:
            eng.set_frequency(args.frequency)
        eng.drain(policy=tuner)
        summary = summarize(eng, tuner)
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
