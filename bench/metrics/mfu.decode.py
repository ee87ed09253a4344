"""The whole decode step's share of the card's bf16 peak: the operations
that the configuration needs for the traced decode-only iterations (their
occupied rows at their contexts, ``configs/<config>.py decode_flops``)
over the time the card was busy in them, over 989 TFLOP/s (%)."""
from bench import peaks
from bench.trace import busy_time


def read(run):
    tr = run.traced
    if tr is None:
        return None
    flops = busy = 0.0
    for i, kernels in tr.kernels.items():
        it = run.all_iterations[i]
        if it.rows and not it.bucket and kernels:
            flops += run.model.decode_flops(run.config, it.contexts)
            busy += busy_time(kernels)
    if busy <= 0:
        return None
    return 100.0 * flops / busy / peaks.PEAK_FLOPS["bf16"]
