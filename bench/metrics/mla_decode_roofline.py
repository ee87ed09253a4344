"""The latent-space MLA decode kernel (``csrc/mla_decode.cu``, both of its
passes) against its roofline: the least time its launches in the traced
iterations with decode rows could take (``mla_decode_bytes`` of the
iteration's occupied rows at their contexts, as ``mfu.decode`` reads
them, at 3.35 TB/s; the launches from the decode graph's capture count,
``mla_decode``) over the device time of its kernels there (%). A program
without the kernel reads nothing."""
from bench import peaks
from bench.trace import kernel_time


def mla_decode_bytes(contexts, heads: int, rank: int, rope: int,
                     itemsize: int = 2) -> int:
    """The bytes one launch needs for rows whose contexts (cached tokens)
    are ``contexts``: each row's valid latents, its cached tokens and its
    own new entry (rank + rope wide), read once; its query in the latent
    space (heads x (rank + rope)) read once and its output in the latent
    space (heads x rank) written once."""
    width = rank + rope
    return itemsize * sum((c + 1) * width + heads * width + heads * rank
                          for c in contexts)


def read(run):
    tr = run.traced
    if tr is None:
        return None
    m = run.config["model_config"]
    launches = run.decode_launches.get("mla_decode", 0)
    bound = spent = 0.0
    for i, kernels in tr.kernels.items():
        it = run.all_iterations[i]
        if not it.rows:
            continue
        nbytes = mla_decode_bytes(it.contexts, m["num_heads"],
                                  m["kv_lora_rank"], m["qk_rope_head_dim"])
        bound += launches * peaks.bound_s(0.0, nbytes)
        spent += kernel_time(kernels, "mla_decode_")
    return 100.0 * bound / spent if spent > 0 else None
