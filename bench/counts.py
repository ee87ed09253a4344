"""Operations and bytes of the kernels that the per-layer metrics hold to
their rooflines, worked out from the shapes of each call as the operation
needs them: each input byte read once and each output byte written once,
whatever the kernel reads again."""
from __future__ import annotations


def rmsnorm_bytes(rows: int, width: int, fused: bool, itemsize: int = 2
                  ) -> int:
    """An RMSNorm over (rows, width): x read and the normed rows written,
    and the weight read; fused with the residual add before it, r read and
    the sum written too."""
    streams = 4 if fused else 2
    return streams * rows * width * itemsize + width * itemsize


def ssd_scan_cost(tokens: int, heads: int, head_dim: int, groups: int,
                  state: int):
    """(operations, bytes) of the SSD scan over ``tokens`` from a zero
    state, fp32 throughout: x (tokens, heads, head_dim), dt (tokens,
    heads), A (heads), B and C (tokens, groups, state) read; y (tokens,
    heads, head_dim) and the final state (heads, head_dim, state) written.
    The operations are the recurrence's, which is the least the result
    needs: a decay, an outer product and an add per state element and
    token (3), and C times the state (2)."""
    flops = 5 * tokens * heads * head_dim * state
    nbytes = 4 * (2 * tokens * heads * head_dim + tokens * heads + heads
                  + 2 * tokens * groups * state + heads * head_dim * state)
    return flops, nbytes
