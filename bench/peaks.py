"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit), and the roofline of a
count of operations and bytes against them."""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, kind: str = "bf16") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak of their kind and the bytes over the HBM bandwidth."""
    return max(flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S)
