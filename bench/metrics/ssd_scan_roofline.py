"""The SSD scan kernel (``csrc/ssd_scan.cu``) in the prefill forwards
against its roofline: the least time its launches in the traced
iterations could take (``counts.ssd_scan_cost`` of each bucket's tokens,
fp32: operations at the TF32 peak, bytes at 3.35 TB/s; the launches from
the bucket graph's capture counts) over their device time (%)."""
from bench import counts, peaks
from bench.trace import kernel_time


def read(run):
    tr = run.traced
    if tr is None:
        return None
    m = run.config["model_config"]
    d_in = m["ssm_expand"] * m["d_model"]
    heads = d_in // m["ssm_head_dim"]
    bound = spent = 0.0
    for i, kernels in tr.kernels.items():
        it = run.all_iterations[i]
        if not it.bucket:
            continue
        calls = run.prefill_launches[it.bucket].get("ssd_scan", 0)
        flops, nbytes = counts.ssd_scan_cost(it.bucket, heads,
                                             m["ssm_head_dim"],
                                             m["ssm_ngroups"],
                                             m["ssm_state"])
        bound += calls * peaks.bound_s(flops, nbytes, "tf32")
        spent += kernel_time(kernels, "ssd_scan_kernel")
    return 100.0 * bound / spent if spent > 0 else None
