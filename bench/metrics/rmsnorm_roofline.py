"""The RMSNorm kernels (``csrc/rmsnorm.cu``, plain and fused with the
residual add) against their roofline: the least time their calls in the
traced iterations could take (bytes once at 3.35 TB/s; the launches of
each graph's replay from its capture's counts, ``rmsnorm`` and
``rmsnorm_fused``, their rows the decode batch or the prefill bucket)
over the device time of the ``rmsnorm_kernel`` launches there (%)."""
from bench import counts, peaks
from bench.trace import kernel_time


def _bound(launches, rows, d):
    fused = launches.get("rmsnorm_fused", 0)
    plain = launches.get("rmsnorm", 0) - fused
    nbytes = (fused * counts.rmsnorm_bytes(rows, d, True)
              + plain * counts.rmsnorm_bytes(rows, d, False))
    return peaks.bound_s(0.0, nbytes)


def read(run):
    tr = run.traced
    if tr is None:
        return None
    d = run.config["model_config"]["d_model"]
    bound = spent = 0.0
    for i, kernels in tr.kernels.items():
        it = run.all_iterations[i]
        if it.bucket:
            bound += _bound(run.prefill_launches[it.bucket], it.bucket, d)
        if it.rows:
            bound += _bound(run.decode_launches, run.max_batch, d)
        spent += kernel_time(kernels, "rmsnorm_kernel")
    return 100.0 * bound / spent if spent > 0 else None
