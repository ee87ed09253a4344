"""AGFT across the assigned architecture zoo: the same tuner binary drives
serving engines for architectures with very different compute/memory
balances (dense / MoE / MLA / SSM / hybrid) and learns a different optimal
frequency for each — the workload-conditional behaviour the paper's
fingerprint is designed to expose.

The port's copy of ``examples/multi_arch_serving.py``: the same script
with ``repro`` rewritten to ``repro_torch``.

  PYTHONPATH=src python examples/torch_multi_arch_serving.py
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.energy import A6000
from repro_torch.policies import get_policy
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.workloads import PROTOTYPES, generate_requests

ARCHS = ["tinyllama-1.1b", "llama3-3b", "deepseek-v2-lite-16b",
         "mamba2-1.3b", "recurrentgemma-9b"]


def main():
    print(f"{'arch':24s} {'f* (MHz)':>9s} {'energy':>8s} {'tpot':>8s} "
          f"{'EDP':>8s}")
    for arch in ARCHS:
        results = {}
        for with_tuner in (False, True):
            eng = InferenceEngine(get_config(arch), EngineConfig(),
                                  hardware=A6000,
                                  initial_frequency=A6000.f_max)
            eng.submit(generate_requests(PROTOTYPES["normal"], 600,
                                         base_rate=3.0, seed=5))
            tuner = get_policy("agft") if with_tuner else None
            eng.drain(policy=tuner)
            fin = eng.finished
            tpot = float(np.mean([r.tpot for r in fin
                                  if r.tpot is not None]))
            results[with_tuner] = (eng.metrics.c.energy_joules_total, tpot,
                                   tuner)
        (eb, tb, _), (ea, ta, tuner) = results[False], results[True]
        post = [h["freq"] for h in tuner.history if h["converged"]]
        fstar = np.mean(post) if post else float("nan")
        print(f"{arch:24s} {fstar:9.0f} {100*(1-ea/eb):+7.1f}% "
              f"{100*(ta/tb-1):+7.1f}% "
              f"{100*(1-(ea*ta)/(eb*tb)):+7.1f}%")


if __name__ == "__main__":
    main()
