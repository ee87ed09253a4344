"""The port's kernel entry points, in the (B,S,H,D) calling conventions of
``repro.kernels.ops``. Dispatch is by tensor device: a CUDA tensor launches
the hand-written Hopper kernel, a CPU tensor runs its plain version, any
other device raises. There is no fallback from a kernel to its plain
version. The Hopper kernels pick their own tiles, so the ``block_q`` and
``block_k`` arguments of the reference signatures are not taken.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.rmsnorm import rmsnorm as _rms


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B,S,H,D); k,v: (B,S,Hkv,D) -> (B,S,H,D)."""
    return _fa(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B,1,H,D); caches: (B,T,Hkv,D); valid: (B,T) -> (B,1,H,D)."""
    return _dec(q, k_cache, v_cache, valid)


def rmsnorm(x, weight, *, eps: float = 1e-6):
    return _rms(x, weight, eps=eps)
