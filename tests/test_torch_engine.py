"""Integration: the port's serving engine driving REAL PyTorch forward
passes (reduced tinyllama) through ``TorchBackend`` on the CPU, with AGFT
attached — the copy of ``tests/test_jax_backend.py`` for the port. On the
CPU the model's kernel calls run their plain versions."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import AGFTConfig, AGFTTuner
from repro_torch.energy import A6000, H100
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.policies import get_policy
from repro_torch.serving import EngineConfig, InferenceEngine, TorchBackend
from repro_torch.workloads import PROTOTYPES, generate_requests


def test_engine_with_real_torch_execution():
    cfg = get_config("tinyllama-1.1b").reduced()
    backend = TorchBackend(cfg, A6000, max_batch=4, cache_len=64,
                           device="cpu")
    eng = InferenceEngine(cfg, EngineConfig(max_num_seqs=4,
                                            max_batched_tokens=256,
                                            prefill_chunk=64),
                          hardware=A6000, backend=backend,
                          initial_frequency=A6000.f_max)
    reqs = generate_requests(PROTOTYPES["normal"], 6, base_rate=50.0, seed=0)
    for r in reqs:
        r.prompt_len = min(r.prompt_len, 48)
        r.output_len = min(r.output_len, 8)
    eng.submit(reqs)
    tuner = AGFTTuner(A6000, AGFTConfig(sampling_period_s=0.2))
    reset_launch_counts()
    eng.drain(policy=tuner, max_iters=2000)
    assert len(eng.finished) == 6
    assert eng.metrics.c.energy_joules_total > 0
    assert all(r.generated == r.output_len for r in eng.finished)
    # the tuner must have acted through the same interface as in sim mode
    assert tuner.round >= 0
    assert eng.frequency >= A6000.f_min
    # the backend runs the kernel configuration; on the CPU that is the
    # plain versions, which are not counted as launches
    assert backend.cfg.use_pallas
    assert backend.prefill_steps > 0 and backend.decode_steps > 0
    assert launch_counts() == {"rmsnorm": 0, "rmsnorm_fused": 0,
                               "flash_attention": 0, "decode_attention": 0,
                               "ssd_scan": 0, "rglru_scan": 0,
                               "mla_decode": 0, "mla_decode_wide": 0,
                               "ssd_step": 0, "rglru_gated": 0,
                               "rglru_gated_step": 0}


def test_backend_defaults_to_h100_and_the_registered_agft():
    cfg = get_config("llama3-3b").reduced()
    backend = TorchBackend(cfg, device="cpu")
    assert backend.dvfs.spec is H100
    assert backend.cache["scanned"].k.shape == (
        cfg.num_layers, 8, 256, cfg.num_kv_heads, cfg.head_dim)
    assert isinstance(get_policy("agft", H100, sampling_period_s=0.2),
                      AGFTTuner)


def test_backend_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend(cfg)
