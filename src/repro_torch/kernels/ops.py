"""The port's kernel entry points, in the (B,S,H,D) calling conventions of
``repro.kernels.ops``. Dispatch is by tensor device: a CUDA tensor launches
the hand-written Hopper kernel, a CPU tensor runs its plain version, any
other device raises. There is no fallback from a kernel to its plain
version. The Hopper kernels pick their own tiles, so the ``block_q``,
``block_k``, ``block_w`` and ``block_s`` arguments of the reference
signatures are not taken.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.mla_decode import mla_decode as _mla
from repro_torch.kernels.rglru import rglru_gated_scan as _rglru_gated
from repro_torch.kernels.rglru import rglru_scan as _rglru
from repro_torch.kernels.rmsnorm import add_rmsnorm as _add_rms
from repro_torch.kernels.rmsnorm import rmsnorm as _rms
from repro_torch.kernels.ssd import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B,S,H,D); k,v: (B,S,Hkv,D) -> (B,S,H,D)."""
    return _fa(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B,1,H,D); caches: (B,T,Hkv,D); valid: (B,T) -> (B,1,H,D)."""
    return _dec(q, k_cache, v_cache, valid)


def mla_decode(q, c_kv, k_rope, valid, scale: float):
    """q (B,H,R+RP) in the latent space; c_kv (B,T,R); k_rope (B,T,RP);
    valid (B,T) -> o_lat (B,H,R)."""
    return _mla(q, c_kv, k_rope, valid, scale)


def rmsnorm(x, weight, *, eps: float = 1e-6):
    return _rms(x, weight, eps=eps)


def add_rmsnorm(x, r, weight, *, eps: float = 1e-6):
    """(s, rmsnorm(s)) with s = x + r, in one launch on the card."""
    return _add_rms(x, r, weight, eps=eps)


def rglru_scan(x, log_a, h0):
    """x, log_a (B,S,W); h0 (B,W) -> (ys, h_last), all fp32."""
    return _rglru(x.float(), log_a.float(), h0.float())


def rglru_gated_scan(xc, pre_i, pre_r, lam, pre_y, h0):
    """The RG-LRU block's gates, recurrence and output gate in one launch
    on the card: xc, pre_i, pre_r (B,S,W); lam (W,); pre_y (B,S,W) in the
    activation dtype; h0 (B,W) -> (out in pre_y's dtype, h_last fp32)."""
    return _rglru_gated(xc.float(), pre_i.float(), pre_r.float(),
                        lam.float(), pre_y, h0.float())


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """Chunked SSD, shapes as ``repro_torch.kernels.ref.ssd_scan``, all
    fp32. The chunk is halved until it divides S (chunk 1 at S = 1)."""
    s = x.shape[1]
    ck = chunk
    while s % ck:
        ck //= 2
    return _ssd(x.float(), dt.float(), A.float(), B.float(), C.float(),
                chunk=max(ck, 1))
