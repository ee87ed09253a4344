"""Mamba-2's decode step kernel (``csrc/ssd_step.cu``) against its
roofline: the least time its launches in the traced iterations with decode
rows could take (``ssd_step_cost`` of the iteration's occupied rows: fp32
operations at the CUDA cores' peak, bytes at 3.35 TB/s; the launches from
the decode graph's capture count, ``ssd_step``) over the device time of its
kernels there (%). A program without the kernel reads nothing."""
from bench import peaks
from bench.trace import kernel_time


def ssd_step_cost(rows: int, heads: int, head_dim: int, groups: int,
                  state: int):
    """(fp32 operations, bytes) one launch needs for ``rows`` occupied
    rows: each row's state (heads x head_dim x state fp32) read once and
    written once, its x read and y written (heads x head_dim), its dt
    (heads), B and C (groups x state), and A and D once a launch; six
    operations a state element (B x, times dt, S dA, the add, C S') and two
    a (head, p) (D x and its add)."""
    if not rows:
        return 0.0, 0
    hp = heads * head_dim
    per_row = 2 * hp * state + 2 * hp + heads + 2 * groups * state
    flops = rows * (6.0 * hp * state + 2.0 * hp)
    return flops, 4 * (rows * per_row + 2 * heads)


def read(run):
    tr = run.traced
    if tr is None:
        return None
    m = run.config["model_config"]
    heads = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    launches = run.decode_launches.get("ssd_step", 0)
    bound = spent = 0.0
    for i, kernels in tr.kernels.items():
        it = run.all_iterations[i]
        if not it.rows:
            continue
        flops, nbytes = ssd_step_cost(it.rows, heads, m["ssm_head_dim"],
                                      m["ssm_ngroups"], m["ssm_state"])
        bound += launches * peaks.bound_s(flops, nbytes, "fp32")
        spent += kernel_time(kernels, "ssd_step_")
    return 100.0 * bound / spent if spent > 0 else None
