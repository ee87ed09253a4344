"""Fleet-level AGFT (beyond-paper): a 4-node cluster with per-node power
policies and a length-segregating router — nodes specialize and learn
different frequencies for their traffic class. Also shows a heterogeneous
per-node policy mix (AGFT on the long-context half, an SLO controller and
the ondemand governor on the chat half) and the fleet-global controller
(one frequency for every node, learned from aggregated telemetry) through
the same discrete-event driver.

The port's copy of ``examples/cluster_serving.py``: the same script with
``repro`` rewritten to ``repro_torch``.

  PYTHONPATH=src python examples/torch_cluster_serving.py
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving.cluster import ServingCluster, route_by_length
from repro_torch.workloads import PROTOTYPES, generate_requests


def trace(n=800, seed=13):
    return (generate_requests(PROTOTYPES["long_context"], n // 2,
                              base_rate=3.0, seed=seed)
            + generate_requests(PROTOTYPES["normal"], n // 2,
                                base_rate=3.0, seed=seed + 1))


def main():
    cfg = get_config("llama3-3b")
    base = ServingCluster(cfg, n_nodes=4, with_tuners=False,
                          router=route_by_length)
    base.submit(trace())
    base.drain()
    tuned = ServingCluster(cfg, n_nodes=4, with_tuners=True,
                           router=route_by_length)
    tuned.submit(trace())
    tuned.drain()

    b, t = base.summary(), tuned.summary()
    print(f"fleet energy : {t.energy_j/1e3:9.1f} kJ vs {b.energy_j/1e3:9.1f}"
          f" kJ ({100*(1-t.energy_j/b.energy_j):+.1f}%)")
    print(f"fleet EDP    : {t.edp:9.1f} vs {b.edp:9.1f} "
          f"({100*(1-t.edp/b.edp):+.1f}%)")
    for i, tun in enumerate(tuned.policies):
        post = [h["freq"] for h in tun.history if h["converged"]]
        kind = "long-context" if i < 2 else "chat"
        f = np.mean(post) if post else float("nan")
        print(f"node {i} ({kind:12s}): learned f* = {f:6.0f} MHz "
              f"({len(post)} exploit windows)")

    # heterogeneous per-node mix through the same driver: AGFT where the
    # traffic is hard, cheaper controllers where it is predictable
    mixed = ServingCluster(cfg, n_nodes=4, router=route_by_length,
                           policies=["agft", "agft", "slo", "ondemand"])
    mixed.submit(trace())
    mixed.drain()
    m = mixed.summary()
    print(f"mixed fleet  : {m.energy_j/1e3:9.1f} kJ "
          f"({100*(1-m.energy_j/b.energy_j):+.1f}% vs baseline), "
          f"node policies = "
          f"{[type(p).__name__ for p in mixed.policies]}")

    # cross-node coordination baseline: ONE controller, one frequency for
    # the whole fleet, driven by summed telemetry — what per-node loops
    # are measured against (benchmarks.tab_fleet does this exhaustively)
    glob = ServingCluster(cfg, n_nodes=4, router=route_by_length,
                          fleet_policy="global")
    glob.submit(trace())
    glob.drain()
    g = glob.summary()
    print(f"global fleet : {g.energy_j/1e3:9.1f} kJ "
          f"({100*(1-g.energy_j/b.energy_j):+.1f}% vs baseline), "
          f"single f* = {g.node_frequencies[0]:.0f} MHz "
          f"({len(glob.fleet_policy.history)} fleet ticks)")


if __name__ == "__main__":
    main()
