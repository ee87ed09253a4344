"""Quickstart: the AGFT closed loop in ~40 lines.

Builds the continuous-batching engine for the paper's Llama-3-3B serving
setup (simulated A6000 DVFS backend), runs the 'normal' workload prototype
with and without AGFT, and prints the energy/latency/EDP comparison.
Any registered power policy drops in the same way — try
``get_policy("ondemand")`` or ``get_policy("static", frequency_mhz=1200)``.

The port's copy of ``examples/quickstart.py``: the same script with ``repro``
rewritten to ``repro_torch``.

  PYTHONPATH=src python examples/torch_quickstart.py
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.energy import A6000
from repro_torch.policies import get_policy
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.workloads import PROTOTYPES, generate_requests


def serve(policy=None, n=800, seed=7):
    engine = InferenceEngine(get_config("llama3-3b"), EngineConfig(),
                             hardware=A6000,
                             initial_frequency=A6000.f_max)
    engine.submit(generate_requests(PROTOTYPES["normal"], n,
                                    base_rate=3.0, seed=seed))
    engine.drain(policy=policy)
    fin = engine.finished
    tpot = float(np.mean([r.tpot for r in fin if r.tpot is not None]))
    return {
        "energy_j": engine.metrics.c.energy_joules_total,
        "ttft_s": float(np.mean([r.ttft for r in fin])),
        "tpot_s": tpot,
        "edp": engine.metrics.c.energy_joules_total * tpot,
    }


def main():
    print("baseline (unlocked frequency)...")
    base = serve()
    print("AGFT (online contextual bandit)...")
    tuner = get_policy("agft")
    agft = serve(policy=tuner)

    print(f"\n{'metric':10s} {'baseline':>12s} {'AGFT':>12s} {'diff':>8s}")
    for k in ("energy_j", "ttft_s", "tpot_s", "edp"):
        d = 100 * (agft[k] / base[k] - 1)
        print(f"{k:10s} {base[k]:12.4f} {agft[k]:12.4f} {d:+7.1f}%")
    print(f"\nconverged after {tuner.first_converged_round} decision rounds; "
          f"{len(tuner.pruner.permanently_pruned)} frequencies pruned; "
          f"{len(tuner.refiner.log)} action-space refinements")


if __name__ == "__main__":
    main()
