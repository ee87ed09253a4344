"""End-to-end serving driver (the paper's scenario): a long non-stationary
Azure-style request stream served with continuous batching while AGFT tunes
the frequency online. Prints a rolling report of regime shifts, frequency
decisions and cumulative savings, then a final comparison vs baseline.

The port's copy of ``examples/serve_agft.py``: the same script with ``repro``
rewritten to ``repro_torch``.

  PYTHONPATH=src python examples/torch_serve_agft.py --duration 1800
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.energy import A6000
from repro_torch.policies import get_policy
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.workloads import generate_azure_trace


def run(duration, rate, seed, with_tuner, report_every=300.0):
    eng = InferenceEngine(get_config("llama3-3b"), EngineConfig(),
                          hardware=A6000, initial_frequency=A6000.f_max)
    eng.submit(generate_azure_trace(duration, base_rate=rate, seed=seed))
    tuner = get_policy("agft") if with_tuner else None
    next_report = report_every
    while eng.has_work:
        eng.run_until(next_report, policy=tuner)
        if with_tuner and eng.has_work:
            c = eng.metrics.c
            print(f"  t={eng.clock:7.0f}s f={eng.frequency:6.0f}MHz "
                  f"P={c.current_power_watts:5.1f}W "
                  f"E={c.energy_joules_total/1e3:8.1f}kJ "
                  f"run={c.requests_running:3d} wait={c.requests_waiting:4d} "
                  f"{'EXPLOIT' if tuner.converged else 'explore'}")
        next_report = eng.clock + report_every
    return eng, tuner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=1800.0)
    ap.add_argument("--rate", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()

    print(f"=== AGFT on a {args.duration:.0f}s Azure-style trace ===")
    eng, tuner = run(args.duration, args.rate, args.seed, True)
    print("=== baseline (same trace, unlocked frequency) ===")
    base, _ = run(args.duration, args.rate, args.seed, False)

    def stats(e):
        fin = e.finished
        tpot = float(np.mean([r.tpot for r in fin if r.tpot is not None]))
        return (e.metrics.c.energy_joules_total, tpot,
                float(np.mean([r.ttft for r in fin])))

    ea, ta, fa = stats(eng)
    eb, tb, fb = stats(base)
    print(f"\nenergy  : {ea/1e3:9.1f} kJ vs {eb/1e3:9.1f} kJ "
          f"({100*(1-ea/eb):+.1f}% saving)")
    print(f"TPOT    : {ta*1e3:9.2f} ms vs {tb*1e3:9.2f} ms "
          f"({100*(ta/tb-1):+.1f}%)")
    print(f"TTFT    : {fa*1e3:9.2f} ms vs {fb*1e3:9.2f} ms "
          f"({100*(fa/fb-1):+.1f}%)")
    print(f"EDP     : {ea*ta:9.1f} vs {eb*tb:9.1f} "
          f"({100*(1-(ea*ta)/(eb*tb)):+.1f}% improvement)")
    print(f"adaptive: reopened exploration {tuner.convergence.reopened}x "
          f"across workload regime shifts")


if __name__ == "__main__":
    main()
