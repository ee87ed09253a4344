"""The port's bf16 path, the dtype it serves in, against the JAX package's,
on the CPU: one Mamba-2 block and one RG-LRU block, and the reduced
``MambaLM`` and ``HybridLM`` on the JAX init's bf16 weights (converted by
``repro_torch.models.convert``), with ``use_pallas`` off and on.

Two bf16 paths differ wherever one rounding flips, and the flips grow
through the layers (JAX's own bf16 logits move further from its fp32
logits with each layer), so bf16 outputs are not compared elementwise.
Each is measured against JAX's fp32 output on the same weights and inputs,
in units of JAX's own bf16 distance from it:

- one block rounds where JAX's block rounds, so its bf16 output lies
  within BF16_BLOCK of JAX's bf16 output. The port stays well inside that
  (its recurrent steps match JAX's bit for bit), while an op run in bf16
  where JAX runs it in fp32, or the other way round, or a cast moved,
  lands about half a unit or more away;
- a model's bf16 logits lie as far from JAX's fp32 logits as JAX's bf16
  logits do, within BF16_TRACK, and no further from JAX's bf16 logits
  than BF16_VS_JAX: two paths that round alike but independently sit
  about sqrt(2) units apart.

Every state and cache keeps the dtypes of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import blocks, build_model
from repro_torch.models.convert import from_jax_params, to_tensor

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
F32 = dict(dtype="float32", param_dtype="float32")
BF16_BLOCK = 0.1
BF16_TRACK = 1.25
BF16_VS_JAX = 1.5

SSM, HYBRID = "mamba2-1.3b", "recurrentgemma-9b"
# (arch, the JAX block's init and forward, the port's forward and state)
BLOCKS = {
    SSM: (jblocks.init_ssd_block, jblocks.ssd_block_forward,
          blocks.ssd_block_forward, blocks.SSDState),
    HYBRID: (jblocks.init_rglru_block, jblocks.rglru_block_forward,
             blocks.rglru_block_forward, blocks.RGLRUState),
}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _units(t16, j16, j32):
    """(port's distance from JAX fp32, from JAX bf16), in units of JAX
    bf16's distance from JAX fp32."""
    assert t16.dtype == torch.bfloat16 and j16.dtype == jnp.bfloat16
    t16 = t16.float().numpy()
    d_jax = _rel_l2(j16, j32)
    return _rel_l2(t16, j32) / d_jax, _rel_l2(t16, j16) / d_jax


def _dtypes(tree, prefix=""):
    """{path, list indices left out: dtype name} of a state's leaves."""
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = (("", v) for v in tree)
    else:
        return {prefix: str(tree.dtype).removeprefix("torch.")}
    out = {}
    for k, v in items:
        out.update(_dtypes(v, f"{prefix}/{k}" if k else prefix))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_bf16_block_matches_jax(arch, use_pallas):
    """One block over 40 tokens (the chunked SSD or the RG-LRU scan), then
    its one-token step from the state JAX's block returned."""
    j_init, j_fwd, t_fwd, t_state = BLOCKS[arch]
    jcfg = jax_get_config(arch).reduced().replace(use_pallas=use_pallas,
                                                   **BF16)
    cfg = get_config(arch).reduced().replace(use_pallas=use_pallas, **BF16)
    j32cfg = jcfg.replace(**F32)
    p = j_init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, p), device="cpu")
    S = 40
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, S + 1, jcfg.d_model)), jnp.bfloat16)
    tx = to_tensor(np.asarray(x), "cpu")
    j16, js = j_fwd(p, jcfg, x[:, :S])
    j32, _ = j_fwd(p, j32cfg, x[:, :S].astype(jnp.float32))
    t16, ts = t_fwd(tp, cfg, tx[:, :S])
    assert _units(t16, j16, j32)[1] <= BF16_BLOCK
    assert _dtypes(ts) == _dtypes(js)
    state = t_state(*(to_tensor(np.asarray(a), "cpu") for a in js))
    js32 = js._replace(conv=js.conv.astype(jnp.float32))
    j16, js = j_fwd(p, jcfg, x[:, S:], js)
    j32, _ = j_fwd(p, j32cfg, x[:, S:].astype(jnp.float32), js32)
    t16, ts = t_fwd(tp, cfg, tx[:, S:], state)
    assert _units(t16, j16, j32)[1] <= BF16_BLOCK
    assert _dtypes(ts) == _dtypes(js)


@pytest.mark.parametrize("arch,num_layers,use_pallas", [
    (SSM, 2, False), (SSM, 2, True), (SSM, 8, True),
    (HYBRID, 3, False), (HYBRID, 3, True), (HYBRID, 5, False),
    (HYBRID, 5, True)])
def test_bf16_model_tracks_jax(arch, num_layers, use_pallas):
    """The reduced model in bf16 on the JAX init's bf16 weights: forward,
    prefill and four decode steps against JAX's bf16 and fp32 runs on the
    same weights. Mamba-2 at 2 layers and at 8, where the drift has grown;
    the hybrid at 3 (no tail) and 5 (a tail of two), its prefill of 40
    tokens past the reduced window of 32."""
    kw = dict(num_layers=num_layers, use_pallas=use_pallas)
    jm = jax_build_model(jax_get_config(arch).reduced().replace(**kw,
                                                                **BF16))
    jm32 = jax_build_model(jax_get_config(arch).reduced().replace(**kw,
                                                                  **F32))
    cfg = get_config(arch).reduced().replace(**kw, **BF16)
    tm = build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params),
                              device="cpu")
    B, S = 2, 40
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 4))
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)

    def tracks(t16, j16, j32):
        track, vs_jax = _units(t16, j16, j32)
        assert track <= BF16_TRACK and vs_jax <= BF16_VS_JAX, (track,
                                                               vs_jax)

    tracks(tm.forward(tparams, tt[:, :S])[0],
           jm.forward(params, jt[:, :S])[0],
           jm32.forward(params, jt[:, :S])[0])
    jl, jc = jm.prefill(params, jt[:, :S])
    jl32, jc32 = jm32.prefill(params, jt[:, :S])
    tl, tc = tm.prefill(tparams, tt[:, :S])
    tracks(tl, jl, jl32)
    assert _dtypes(tc) == _dtypes(jc)
    for i in range(4):
        pos = np.full((B,), S + i)
        tok = slice(S + i, S + i + 1)
        jl, jc = jm.decode_step(params, jt[:, tok], jc,
                                jnp.asarray(pos, jnp.int32))
        jl32, jc32 = jm32.decode_step(params, jt[:, tok], jc32,
                                      jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tparams, tt[:, tok], tc,
                                torch.from_numpy(pos))
        tracks(tl, jl, jl32)
    assert _dtypes(tc) == _dtypes(jc)
