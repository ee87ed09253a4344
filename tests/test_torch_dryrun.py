"""The port's dry-run (``repro_torch.launch.dryrun``) and the DTensor path
of its models, on the CPU.

* The 5 (arch, shape) pairs of ``tests/test_dryrun.py`` on the 2x4 and
  2x2x4 debug meshes through the CLI, and its HLO parser beside the
  reference's.
* FLOPs: (tinyllama-1.1b, train_4k) at full depth must read, in
  ``flops_global``, the matmul count of its 22 layers and lm_head done by
  hand: the forward, the remat recompute (each layer's forward but its
  last product, whose output no backward needs: ``torch.utils.checkpoint``
  stops recomputing once every saved tensor is back) and the backward
  (twice the forward), exactly. Two products on the 2x4 mesh read a quarter
  of their count, one rank's share, in ``flops``, and the whole count
  unplaced, as ``flops_global`` is taken.
* The vocab-parallel loss all-reduces (B, S) values and gathers no logits.
* On real tensors: reduced dense, hybrid and Mamba-2 models placed on a
  2x2 mesh of four gloo processes, and a dense model with fewer kv heads
  than the model axis, one whose query and kv heads the model axis does
  not divide and the MLA/MoE model on a 1x4 mesh, give the plain
  models' loss, gradients and decode logits at fp32 2e-5 (head-parallel
  and context-parallel caches); placed on one rank, its train step equals
  the plain step bit for bit, and the dry-run's counts equal
  ``FlopCounterMode`` and the bytes placed.

Every test sets up and destroys its own process group.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.dryrun import collective_bytes as jax_collective_bytes
from repro_torch.configs import get_config
from repro_torch.data import synthetic_token_batches
from repro_torch.distributed import (PSpec, batch_pspec, cache_pspecs,
                                     logits_pspec, param_pspecs,
                                     with_sharding)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model, tree_tensors
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.training import init_adamw, make_train_step
from repro_torch.training.train_loop import to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = 2e-5


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# tests/test_dryrun.py on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", [
    ("tinyllama-1.1b", "train_4k"),        # dense train
    ("deepseek-v2-lite-16b", "decode_32k"),  # MoE + MLA decode
    ("mamba2-1.3b", "long_500k"),          # SSM long-context decode
    ("recurrentgemma-9b", "decode_32k"),   # hybrid decode
    ("whisper-medium", "prefill_32k"),     # enc-dec prefill
])
def test_debug_mesh_runs(arch, shape, mesh, tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", arch, "--shape", shape, "--debug-mesh",
                     "--mesh", mesh, "--out", out])
    assert done.value.code == 0, capsys.readouterr().out[-2000:]
    assert "1 ok, 0 failed" in capsys.readouterr().out
    with open(out) as f:
        (r,) = json.load(f)["results"]
    assert r["mesh"] == ("2x4" if mesh == "pod" else "2x2x4")
    assert r["devices"] == (8 if mesh == "pod" else 16)
    assert 0 < r["flops"] <= r["flops_global"]
    assert r["memory"]["argument_size_bytes"] > 0
    temp = r["memory"]["temp_size_bytes"]
    assert isinstance(temp, int) and temp > 0
    assert r["collective_bytes"]["total"] == sum(
        v for k, v in r["collective_bytes"].items() if k != "total")


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("ep", [False, True])
def test_debug_mesh_runs_the_capacity_dispatch(ep, mesh):
    """The placed step of llama4-scout-17b-a16e x train_4k (2 layers) with
    the capacity dispatch, without and with the expert-parallel
    constraint, runs on the 2x4 and 2x2x4 debug meshes; with the
    constraint its FLOPs a rank are an even split of the whole step's
    within ``dryrun.JAX_FLOPS_BOUND`` and its buffer's rows come by a
    reduce-scatter; without it each data rank runs its experts on the
    whole buffer, which no reduce-scatter splits."""
    cfg = get_config("llama4-scout-17b-a16e").replace(
        num_layers=2, moe_dispatch="capacity", moe_ep_constraint=ep)
    r = dryrun.run_one("llama4-scout-17b-a16e", "train_4k", verbose=False,
                       debug_mesh=True, multi_pod=mesh == "multipod",
                       cfg_override=cfg)
    share = r["flops"] * r["devices"] / r["flops_global"]
    assert share >= 1
    if ep:
        assert share <= dryrun.JAX_FLOPS_BOUND, share
    coll = r["collective_bytes"]
    assert coll["reduce-scatter"] > 0 if ep else coll["reduce-scatter"] == 0


def test_collective_bytes_parser():
    hlo = """
  %ar = f32[128,256] all-reduce(%x), replica_groups={}
  %ag.1 = bf16[4,1024] all-gather(%y), dimensions={0}
  %cp = f32[16] collective-permute(%z), source_target_pairs={{0,1}}
  %dot = f32[128,256] dot(%a, %b)
"""
    out = dryrun.collective_bytes(hlo)
    assert out["all-reduce"] == 128 * 256 * 4 * 2          # 2x convention
    assert out["all-gather"] == 4 * 1024 * 2
    assert out["collective-permute"] == 16 * 4
    assert out["total"] == (out["all-reduce"] + out["all-gather"]
                            + out["collective-permute"])
    assert out == jax_collective_bytes(hlo)


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def test_full_depth_flops_match_the_matmul_count():
    r = dryrun.run_one("tinyllama-1.1b", "train_4k", debug_mesh=True,
                       verbose=False, extrapolate=True)
    cfg = get_config("tinyllama-1.1b")
    B, S = 256, 4096
    N, d, L, V = B * S, cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, Hkv, hd, f = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.d_ff)
    layer = 2 * N * (d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * f)
    layer += 2 * (2 * B * H * S * S * hd)          # scores and probs @ v
    last = 2 * N * f * d                           # w_out, not recomputed
    head = 2 * N * d * V
    want = L * (layer + (layer - last) + 2 * layer) + 3 * head
    assert L == 22
    assert r["flops_global"] == want
    ext = r["extrapolated"]
    assert ext["scan_length"] == 22
    assert ext["flops"] == r["flops"]
    # u2_*: the bytes of the u = 2 variant (2 layers), as the JAX
    # package's are, not the full-depth step's
    u2 = dryrun._cost_variant(cfg, 2)
    assert u2.num_layers == 2
    with dryrun.fake_process_group(8):
        fn, args = dryrun.build_lowering(
            "tinyllama-1.1b", "train_4k",
            make_debug_mesh(device_type="cpu"), cfg_override=u2)
        arg_bytes = dryrun.local_bytes(args)
        _, counter = dryrun.count_step(fn, args)
    assert ext["u2_temp_bytes"] == counter.temp_bytes > 0
    assert ext["u2_arg_bytes"] == arg_bytes
    assert ext["u2_temp_bytes"] < r["memory"]["temp_size_bytes"]
    assert ext["u2_arg_bytes"] < r["memory"]["argument_size_bytes"]


def test_flops_per_rank_and_global():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    plain = [torch.empty(256, 3072, device="meta"),
             torch.empty(3072, 8192, device="meta"),
             torch.empty(8192, 3072, device="meta")]

    def products(a, b, c):
        return (a @ b) @ c

    with dryrun.fake_process_group(8):
        mesh = make_debug_mesh(device_type="cpu")
        placed = [distribute_tensor(t, mesh, p) for t, p in zip(plain, (
            [Replicate(), Replicate()], [Replicate(), Shard(1)],
            [Replicate(), Shard(0)]))]
        _, counter = dryrun.count_step(products, placed)
    _, whole = dryrun.count_step(products, plain)
    total = 2 * (2 * 256 * 3072 * 8192)
    assert total == 25769803776                    # 2.577e10
    assert whole.flops == total                    # what flops_global reads
    assert counter.flops == total // 4             # split over model = 4


# ---------------------------------------------------------------------------
# temp_size_bytes
# ---------------------------------------------------------------------------

def hand_counted(a, b):
    """(64, 32) @ (32, 16) in fp32, then the activation and a reduction."""
    h = a @ b                   # 4096 B
    y = torch.relu(h)           # 4096 B, an output: 8192 live
    y.mul_(2)                   # in place: nothing
    a.add_(1)                   # into an argument: nothing
    s = y.t().sum(dim=0)        # a view, then 256 B, an output: 8448 live
    return s, y                 # h is freed on return


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_temp_bytes_match_the_hand_count(device):
    """Exact: h is the one temporary (4096 B); the peak holds it and both
    outputs (8448 B); the outputs are 4352 B."""
    args = (torch.ones(64, 32, device=device),
            torch.ones(32, 16, device=device))
    (s, y), counter = dryrun.count_step(hand_counted, args)
    assert (counter.temp_bytes, counter.peak_bytes,
            counter.new_output_bytes) == (4096, 8448, 4352)
    assert counter.live_bytes == 4352           # h's storage was freed
    if device == "cpu":
        assert torch.equal(s, torch.full((64,), 2.0 * 32 * 16))


_FIRST_AND_NEXT = r'''
import gc, sys
gc.disable()
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models.common import init_shapes
from repro_torch.training import init_adamw, make_train_step
model = build_model(get_config("llama3-3b").reduced())
step = make_train_step(model)
for _ in range(2):
    params = init_shapes(model)
    batch = {k: torch.empty(4, 16, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    _, c = dryrun.count_step(step, (params, init_adamw(params), batch))
    print(c.temp_bytes, c.peak_bytes, c.live_bytes)
'''


def test_first_count_in_a_process_equals_the_next():
    """Exact, with the collector off (so that no cycle is freed by
    chance): the first step a process counts (where torch imports
    ``torch._dynamo`` on first use, and that import's frames, left in a
    reference cycle, would hold the step's tensors) reads the next one's
    counts, and nothing it allocated is live after it but its outputs."""
    out = subprocess.run([sys.executable, "-c", _FIRST_AND_NEXT,
                          os.path.join(REPO, "src")], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    first, nxt = [tuple(map(int, line.split()))
                  for line in out.stdout.split("\n") if line]
    assert first == nxt
    assert first[2] == 12            # the loss, gradient norm and step


def test_remat_lowers_temp_bytes_and_decode_stays_below_train():
    """The reduced llama3-3b at 8 x 256 on a 1x1 mesh: remat on counts
    fewer temp bytes than off (the activations set the peak at this
    shape), and a decode step against 256 slots fewer than either."""
    from repro_torch.configs.shapes import InputShape
    cfg = get_config("llama3-3b").reduced()
    assert cfg.remat
    train = InputShape("train_8x256", 256, 8, "train")
    decode = InputShape("decode_8x256", 256, 8, "decode")
    temps = {}
    with dryrun.fake_process_group(1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        for name, c, shape in (("on", cfg, train),
                               ("off", cfg.replace(remat=False), train),
                               ("decode", cfg, decode)):
            _, counter = dryrun.count_step(*dryrun.build_lowering(
                "llama3-3b", shape.name, mesh, cfg_override=c, shape=shape))
            temps[name] = counter.temp_bytes
    assert 0 < temps["decode"] < temps["on"] < temps["off"]


# ---------------------------------------------------------------------------
# the vocab-parallel loss
# ---------------------------------------------------------------------------

def test_vocab_parallel_loss_gathers_no_logits():
    B, S, V = 8, 16, 512
    with dryrun.fake_process_group(8):
        mesh = make_debug_mesh(device_type="cpu")
        logits = with_sharding(torch.empty(B, S, V, device="meta"),
                               logits_pspec(mesh, B, V), mesh)
        logits.requires_grad_(True)
        labels = with_sharding(
            torch.empty(B, S, dtype=torch.int32, device="meta"),
            batch_pspec(mesh, B), mesh)

        def loss_and_grad(lg, lab):
            with implicit_replication():
                loss = softmax_cross_entropy(lg, lab)
                loss.backward()
            return loss

        _, counter = dryrun.count_step(loss_and_grad, (logits, labels))
        assert logits.grad.placements == logits.placements
    coll = counter.collective_bytes()
    assert coll["all-gather"] == 0 and coll["all-to-all"] == 0
    assert coll["reduce-scatter"] == 0
    # three (B/2, S) fp32 all-reduces over model, then the mean's scalars
    local_rows = (B // 2) * S * 4
    assert 3 * 2 * local_rows <= coll["all-reduce"] < 4 * 2 * local_rows


# ---------------------------------------------------------------------------
# real tensors: four gloo ranks, and one rank
# ---------------------------------------------------------------------------

_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.distributed import (batch_pspec, cache_pspecs,
                                     param_pspecs, with_sharding)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model, tree_tensors

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
sys.path.insert(0, sys.argv[6])
from test_torch_dryrun import (BATCH, CHUNKED, CHUNKED_SEQ, DECODE_ONLY,
                               MESHES, PREFILL, SLOTS, config, first_kv,
                               kept_set, long_tokens, watched)
from repro_torch.distributed import parallel
# the attentions the placed ops run, by name
routed = []


def recorded(op):
    def run(fn, *args, **kw):
        routed.append(fn.__name__)
        return op(fn, *args, **kw)
    return run


parallel.local_attention = recorded(parallel.local_attention)
parallel.local_heads = recorded(parallel.local_heads)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
results = {}
for name in sys.argv[7].split(","):
    mesh = make_debug_mesh(*MESHES.get(name, (2, 2)), device_type="cpu")
    cfg, B = config(name), BATCH.get(name, 4)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16),
                                         dtype=np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16),
                                           dtype=np.int32))
    placed = with_sharding(params, param_pspecs(params, mesh), mesh)
    for p in tree_tensors(placed):
        p.requires_grad_(True)
    bspec = batch_pspec(mesh, B)
    res = {}
    if name in CHUNKED:
        routed.clear()
        with implicit_replication(), torch.no_grad():
            lg, pre = model.prefill(
                placed, with_sharding(long_tokens(cfg, B), bspec, mesh),
                max_len=CHUNKED_SEQ)
        results[name] = {"chunked": [lg.full_tensor().tolist(),
                                     first_kv(pre).full_tensor().tolist()],
                         "routed": routed[:]}
        continue
    if cfg.moe_dispatch == "capacity":
        with implicit_replication(), torch.no_grad():
            res["kept"] = kept_set(cfg, placed, mesh).tolist()
    if name not in DECODE_ONLY:
        with implicit_replication():
            loss = model.loss(placed, with_sharding(toks, bspec, mesh),
                              with_sharding(labels, bspec, mesh))
            loss.backward()
        res.update(loss=loss.full_tensor().item(),
                   grads=[p.grad.full_tensor().tolist()
                          for p in watched(placed)])
        res["prefill"] = []
        for slots in SLOTS.get(name, (32,)):
            with implicit_replication(), torch.no_grad():
                lg, pre = model.prefill(
                    placed, with_sharding(toks[:, :PREFILL], bspec, mesh),
                    max_len=slots)
            res["prefill"] += [lg.full_tensor().tolist(),
                               first_kv(pre).full_tensor().tolist()]
    cache = model.init_cache(B, 32, device="cpu")
    cache = with_sharding(cache, cache_pspecs(cache, mesh, B), mesh)
    logits = []
    with implicit_replication(), torch.no_grad():
        for step in range(3):
            tok = with_sharding(toks[:, step:step + 1], bspec, mesh)
            pos = with_sharding(torch.full((B,), step, dtype=torch.int32),
                                batch_pspec(mesh, B, extra_dims=0), mesh)
            lg, cache = model.decode_step(placed, tok, cache, pos)
            logits.append(lg.full_tensor().tolist())
    res["decode"] = logits
    res["cache_placements"] = [[type(p).__name__, getattr(p, "dim", None)]
                               for p in first_kv(cache).placements]
    results[name] = res
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


# reduced fp32 models placed on four gloo ranks: on a 2x2 mesh a dense one
# with a head-parallel cache, one whose single kv head sends its cache's
# slots over model, and the hybrid (the RG-LRU recurrence shard by shard);
# on a 1x4 mesh, whose model axis is wider than the kv heads, a dense model
# with 2 kv heads (each rank's query head against the kv head it reads; a
# context-parallel cache) and the MLA/MoE model (an expert and a head a
# rank). Then, in a second group of four processes, on a 2x2 mesh: Mamba-2
# (the SSD on each rank's heads, its layer-split state stepped by rows and
# heads) and the MLA/MoE model's decode of one row, which the data axis
# leaves whole (each data rank attends half the slots); and on a 1x4 mesh
# a dense model with 6 query heads and 2 kv heads, which the model axis
# divides neither: each rank's padded share of 2 query heads (the last
# rank's both padding, the output a partial sum), rank 1's heads 2 and 3
# reading kv heads 0 and 1, two groups; a context-parallel cache
CONFIGS = ("dense", "dense_mqa", "hybrid", "dense_kv2", "moe")
MORE_CONFIGS = ("ssm", "moe_row", "dense_h6", "dense_v511")
# and on a 2x2 mesh the MLA/MoE model's capacity dispatch (2 of its 4
# experts a rank, top-2; the routing of the whole batch, its rows over
# data), at capacity factor 1.25 and at 0.5 (which drops assignments),
# without and with the expert-parallel constraint (the buffer's rows split
# over data too); and a prefill of CHUNKED_SEQ tokens through the chunked
# reference attention on placed tensors: a dense model with 2 kv heads on
# a 1x4 mesh (fewer kv heads than the model axis), with and without a
# sliding window, and MLA on a 2x2 mesh
CAPACITY_CONFIGS = ("moe_cap", "moe_cap_drop", "moe_cap_ep",
                    "moe_cap_ep_drop")
CHUNKED = ("chunk_kv2", "chunk_window", "chunk_mla")
CHUNKED_SEQ = 1024          # attention.CHUNKED_ATTENTION_MIN_SEQ
MESHES = {"dense_kv2": (1, 4), "moe": (1, 4), "dense_h6": (1, 4),
          "chunk_kv2": (1, 4), "chunk_window": (1, 4)}
BATCH = {"moe_row": 1, "chunk_kv2": 2, "chunk_window": 2, "chunk_mla": 2}
DECODE_ONLY = ("moe_row",)
PREFILL = 8                 # tokens a prefill takes, into 32 slots
# and into 30, which the model axis does not divide (its kv heads whole)
SLOTS = {"dense_kv2": (32, 30)}
# the first cache leaf's placements: [data, model]
CACHE_PLACEMENTS = {
    "dense": [["Shard", 1], ["Shard", 3]],
    "dense_mqa": [["Shard", 1], ["Shard", 2]],
    "hybrid": [["Shard", 0], ["Shard", 1]],
    "dense_kv2": [["Shard", 1], ["Shard", 2]],
    "moe": [["Shard", 1], ["Shard", 3]],
    "ssm": [["Shard", 0], ["Replicate", None]],
    "moe_row": [["Replicate", None], ["Shard", 3]],
    "dense_h6": [["Shard", 1], ["Shard", 2]],
    "dense_v511": [["Shard", 1], ["Shard", 3]],
    "moe_cap": [["Shard", 1], ["Shard", 3]],
    "moe_cap_drop": [["Shard", 1], ["Shard", 3]],
    "moe_cap_ep": [["Shard", 1], ["Shard", 3]],
    "moe_cap_ep_drop": [["Shard", 1], ["Shard", 3]],
}


def config(name):
    if name.startswith("moe_cap"):
        return get_config("deepseek-v2-lite-16b").reduced().replace(
            moe_dispatch="capacity",
            capacity_factor=0.5 if name.endswith("drop") else 1.25,
            moe_ep_constraint="_ep" in name)
    if name == "chunk_mla":
        return get_config("deepseek-v2-lite-16b").reduced().replace(
            ref_attention="chunked")
    if name.startswith("chunk_"):
        return get_config("llama3-3b").reduced().replace(
            num_kv_heads=2, ref_attention="chunked",
            attention_window=256 if name == "chunk_window" else 0)
    if name == "hybrid":
        return get_config("recurrentgemma-9b").reduced()
    if name in ("moe", "moe_row"):
        return get_config("deepseek-v2-lite-16b").reduced()
    if name == "ssm":
        return get_config("mamba2-1.3b").reduced()
    if name == "dense_h6":
        return get_config("llama3-3b").reduced().replace(num_heads=6,
                                                         num_kv_heads=2)
    if name == "dense_v511":
        return get_config("llama3-3b").reduced().replace(vocab_size=511)
    return get_config("llama3-3b").reduced().replace(
        num_kv_heads={"dense_mqa": 1, "dense_kv2": 2}.get(name, 4))


def watched(params):
    """The leaves whose gradients the test holds: the embedding and the
    head (vocab-parallel; Mamba-2 ties them), a first-layer weight (the
    hybrid's lambda, replicated over data, its gradient summed over the
    batch's ranks; Mamba-2's in-projection), and an MoE layer's expert
    weights (split over model)."""
    if "units" in params:
        first = params["units"][0]["l0"]["mixer"]["lambda_param"]
    elif "mixer" in params["layers"][0]:
        first = params["layers"][0]["mixer"]["w_in"]
    else:
        first = params["layers"][0]["attn"]["wq"]
    out = [params["embed"], params.get("lm_head"), first]
    if "units" not in params and "attn" in params["layers"][0]:
        out.append(params["layers"][0]["attn"].get("wk"))
    if "moe" in params.get("layers", [{}])[0]:
        out += [params["layers"][0]["moe"]["w_gate"],
                params["layers"][0]["moe"]["router"]]
    return [p for p in out if p is not None]


def long_tokens(cfg, B):
    """The (B, CHUNKED_SEQ) prompt of a chunked prefill."""
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, CHUNKED_SEQ), dtype=np.int32))


def kept_set(cfg, params, mesh=None):
    """The assignments (B, S, K) that the capacity dispatch of the first MoE
    layer's weights keeps for x (4, 16, d), drawn from a seed: placed on
    ``mesh`` (``parallel.moe_capacity``, its rows over the data axis) where
    one is given, else plain (``blocks.capacity_experts``)."""
    from repro_torch.distributed import parallel
    from repro_torch.models import blocks
    p = params["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    C = blocks.moe_capacity(cfg, 4 * 16)
    if mesh is not None:
        x = with_sharding(x, batch_pspec(mesh, 4, extra_dims=2), mesh)
    _, top_w, top_idx = blocks.route(p, cfg, x)
    experts = (p["w_gate"], p["w_in"], p["w_out"])
    if mesh is None:
        return blocks.capacity_experts(x, top_w, top_idx, *experts,
                                       blocks.WholeBuffer(cfg.num_experts,
                                                          C))[1]
    _, keep = parallel.moe_capacity(x, top_w, top_idx, *experts,
                                    capacity=C,
                                    split_rows=cfg.moe_ep_constraint)
    return keep.full_tensor()


def first_kv(cache):
    if "units" in cache:
        return cache["units"][0]["l2"].k
    if not isinstance(cache, dict):
        return cache.ssm
    scanned = cache["scanned"]
    return scanned.c_kv if hasattr(scanned, "c_kv") else scanned.k


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_model_matches_plain_on_four_gloo_ranks(tmp_path):
    check_on_four_gloo_ranks(tmp_path, CONFIGS)


def test_sharded_ssm_and_one_row_mla_match_plain_on_four_gloo_ranks(
        tmp_path):
    check_on_four_gloo_ranks(tmp_path, MORE_CONFIGS)


def test_placed_capacity_dispatch_matches_plain_on_four_gloo_ranks(
        tmp_path):
    """The capacity dispatch placed: the loss, the gradients (the router's
    and an expert weight's among them), the prefill and decode logits and
    the kept set of the plain step, at both capacity factors (0.5 drops
    assignments) and with and without the expert-parallel constraint."""
    check_on_four_gloo_ranks(tmp_path, CAPACITY_CONFIGS)


def test_placed_chunked_prefill_matches_plain_on_four_gloo_ranks(tmp_path):
    """A prefill of CHUNKED_SEQ tokens through the chunked reference
    attention on placed tensors (every layer's attention, on each rank's
    heads) gives the plain prefill's logits and first cache leaf."""
    check_on_four_gloo_ranks(tmp_path, CHUNKED)


def check_on_four_gloo_ranks(tmp_path, names):
    out, port = str(tmp_path / "ranks.json"), _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "4", str(port), out,
         os.path.join(REPO, "src"), os.path.dirname(__file__),
         ",".join(names)], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs[0][-3000:]
    with open(out) as f:
        got = json.load(f)
    assert sorted(got) == sorted(names)
    for name, res in got.items():
        cfg, B = config(name), BATCH.get(name, 4)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        if name in CHUNKED:
            # every layer's attention ran chunked, through a placed op
            want = "_mla_chunked" if cfg.use_mla else "_chunked_attention"
            assert res["routed"] == [want] * cfg.num_layers, name
            with torch.no_grad():
                lg, pre = model.prefill(params, long_tokens(cfg, B),
                                        max_len=CHUNKED_SEQ)
            for got_t, w in zip(res["chunked"], (lg, first_kv(pre))):
                np.testing.assert_allclose(got_t, w.numpy(), rtol=FP32,
                                           atol=FP32, err_msg=name)
            continue
        if cfg.moe_dispatch == "capacity":
            with torch.no_grad():
                want = kept_set(cfg, params)
            assert res["kept"] == want.tolist(), name
            # the tight capacity drops some assignments
            assert want.any() and not (name.endswith("drop")
                                       and want.all())
        for p in tree_tensors(params):
            p.requires_grad_(True)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16),
                                             dtype=np.int32))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16),
                                               dtype=np.int32))
        if name not in DECODE_ONLY:
            loss = model.loss(params, toks, labels)
            loss.backward()
            np.testing.assert_allclose(res["loss"], loss.item(), rtol=FP32,
                                       atol=FP32)
            for i, (got_grad, p) in enumerate(zip(res["grads"],
                                                  watched(params))):
                np.testing.assert_allclose(got_grad, p.grad.numpy(),
                                           rtol=FP32, atol=FP32,
                                           err_msg=f"{name} {i}")
            want = []
            for slots in SLOTS.get(name, (32,)):
                with torch.no_grad():
                    lg, pre = model.prefill(params, toks[:, :PREFILL],
                                            max_len=slots)
                want += [lg, first_kv(pre)]
            assert len(res["prefill"]) == len(want)
            for got_t, w in zip(res["prefill"], want):
                np.testing.assert_allclose(got_t, w.numpy(), rtol=FP32,
                                           atol=FP32, err_msg=name)
        cache = model.init_cache(B, 32, device="cpu")
        with torch.no_grad():
            for step in range(3):
                lg, cache = model.decode_step(
                    params, toks[:, step:step + 1], cache,
                    torch.full((B,), step, dtype=torch.int32))
                np.testing.assert_allclose(res["decode"][step], lg.numpy(),
                                           rtol=FP32, atol=FP32)
        # heads over model where they divide, else the slots (the hybrid's
        # MQA ring too, a list element with no layer axis); MLA's latents
        # over their rank; Mamba-2's state over its layers on data
        assert res["cache_placements"] == CACHE_PLACEMENTS[name]


def _one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def test_placed_step_on_one_rank_equals_plain_step():
    """The CPU rehearsal of ``chip_smoke.py`` phase 8 (b) and (c): a train
    step on params and AdamW state placed on a 1x1 mesh equals the plain
    step bit for bit, and the dry-run's counting of it reads the FLOPs
    ``FlopCounterMode`` reads of the plain step, no collective bytes, the
    bytes of the arguments, and the temp and new-output bytes of the
    plain step, on real tensors and on meta tensors, exactly."""
    from repro_torch.models.common import init_shapes
    cfg = get_config("llama3-3b").reduced()
    model = build_model(cfg)
    batch = to_device(next(synthetic_token_batches(cfg.vocab_size, 4, 16,
                                                   seed=0)), "cpu")
    step = make_train_step(model)

    meta = init_shapes(model)
    _, on_meta = dryrun.count_step(step, (
        meta, init_adamw(meta),
        {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
         for k, v in batch.items()}))
    params = model.init(torch.Generator().manual_seed(0))
    (params, opt, m), on_cpu = dryrun.count_step(
        step, (params, init_adamw(params), batch))
    plain = [t.detach().clone() for t in tree_tensors((params, opt))]
    # counted apart: FlopCounterMode decomposes some ops it has no formula
    # for, which may round otherwise
    params = model.init(torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        step(params, init_adamw(params), batch)

    _one_rank_group()
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        p_specs = param_pspecs(params, mesh)
        args = (with_sharding(params, p_specs, mesh),
                with_sharding(init_adamw(params),
                              dryrun.param_pspecs_like_opt(
                                  init_adamw(params), p_specs), mesh),
                {k: with_sharding(v, batch_pspec(mesh, 4), mesh)
                 for k, v in batch.items()})
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree_tensors((params, init_adamw(params),
                                               batch)))
        assert dryrun.local_bytes(args) == arg_bytes

        def placed_step(*a):
            with implicit_replication():
                return step(*a)

        (pp, po, pm), counter = dryrun.count_step(placed_step, args)
        placed = [t.to_local() if isinstance(t, DTensor) else t
                  for t in tree_tensors((pp, po))]
        assert torch.equal(pm["loss"].full_tensor(), m["loss"])
        assert torch.equal(pm["grad_norm"].full_tensor(), m["grad_norm"])
        assert len(placed) == len(plain)
        assert all(torch.equal(a, b) for a, b in zip(placed, plain))
    finally:
        dist.destroy_process_group()
    assert counter.flops == fc.get_total_flops()
    assert counter.collective_bytes()["total"] == 0
    # metrics: the loss, the gradient norm and the step, 4 B each
    assert on_cpu.new_output_bytes == 12
    assert on_cpu.temp_bytes > 0
    for c in (on_meta, counter):
        assert (c.temp_bytes, c.peak_bytes, c.new_output_bytes) == (
            on_cpu.temp_bytes, on_cpu.peak_bytes, on_cpu.new_output_bytes)


def test_placed_decode_on_one_rank_equals_plain():
    """The CPU rehearsal of phase 8 (d): a prefill and 4 decode steps
    through params and a cache placed on a 1x1 mesh give the plain path's
    logits bit for bit."""
    cfg = get_config("llama3-3b").reduced()
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12), dtype=np.int32))

    def run(params, cache, place):
        out = []
        with torch.no_grad(), implicit_replication():
            lg, pre = model.prefill(params, place(toks[:, :8],
                                                  PSpec(None, None)),
                                    max_len=32)
            out.append(lg)
            for dst, src in zip(tree_tensors(cache), tree_tensors(pre)):
                dst.copy_(src)
            for i in range(4):
                pos = place(torch.full((2,), 8 + i, dtype=torch.int32),
                            PSpec(None))
                lg, cache = model.decode_step(
                    params, place(toks[:, 8 + i:9 + i], PSpec(None, None)),
                    cache, pos)
                out.append(lg)
        return out

    plain = run(model.init(torch.Generator().manual_seed(0)),
                model.init_cache(2, 32, device="cpu"), lambda t, s: t)
    _one_rank_group()
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(2, 32, device="cpu")
        placed = run(with_sharding(params, param_pspecs(params, mesh), mesh),
                     with_sharding(cache, cache_pspecs(cache, mesh, 2), mesh),
                     lambda t, s: with_sharding(t, s, mesh))
        placed = [t.full_tensor() for t in placed]
    finally:
        dist.destroy_process_group()
    assert len(placed) == 5
    assert all(torch.equal(a, b) for a, b in zip(placed, plain))


@pytest.mark.parametrize("ep", [False, True])
def test_placed_capacity_step_on_one_rank_equals_plain_step(ep):
    """The CPU rehearsal of ``chip_smoke.py`` phase 9 (b): the MLA/MoE
    model's train step with the capacity dispatch (without and with the
    expert-parallel constraint), on params and AdamW state placed on a 1x1
    mesh, equals the plain step bit for bit, the updated leaves and the
    metrics; the dry-run's donated form of it (``build_lowering(...,
    donate=True)``) is the step itself, and the undonated form leaves the
    caller's tensors as they were."""
    cfg = get_config("deepseek-v2-lite-16b").reduced().replace(
        moe_dispatch="capacity", capacity_factor=0.5, moe_ep_constraint=ep)
    model = build_model(cfg)
    batch = to_device(next(synthetic_token_batches(cfg.vocab_size, 4, 16,
                                                   seed=0)), "cpu")
    step = make_train_step(model)
    params = model.init(torch.Generator().manual_seed(0))
    params, opt, m = step(params, init_adamw(params), batch)
    plain = [t.detach().clone() for t in tree_tensors((params, opt, m))]

    from repro_torch.configs.shapes import InputShape
    shape = InputShape("train_4x16", 16, 4, "train")
    _one_rank_group()
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        placed = {}
        for donate in (True, False):
            fn, _ = dryrun.build_lowering(
                "deepseek-v2-lite-16b", "train_4k", mesh, cfg_override=cfg,
                shape=shape, donate=donate)
            params = model.init(torch.Generator().manual_seed(0))
            p_specs = param_pspecs(params, mesh)
            args = (with_sharding(params, p_specs, mesh),
                    with_sharding(init_adamw(params),
                                  dryrun.param_pspecs_like_opt(
                                      init_adamw(params), p_specs), mesh),
                    {k: with_sharding(v, batch_pspec(mesh, 4), mesh)
                     for k, v in batch.items()})
            before = [t.to_local().clone() if isinstance(t, DTensor)
                      else t.clone() for t in tree_tensors(args[:2])]
            out = fn(*args)
            placed[donate] = [t.to_local() if isinstance(t, DTensor) else t
                              for t in tree_tensors(out)]
            after = [t.to_local() if isinstance(t, DTensor) else t
                     for t in tree_tensors(args[:2])]
            kept = [torch.equal(a, b) for a, b in zip(before, after)]
            # donated: the params and moments written in place; else left
            assert all(kept) != donate
    finally:
        dist.destroy_process_group()
    for got in placed.values():
        assert len(got) == len(plain)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_placed_chunked_prefill_on_one_rank_equals_plain():
    """The CPU rehearsal of phase 9 (b)'s chunked prefill: a prefill of
    CHUNKED_SEQ tokens through the chunked reference attention, on params
    placed on a 1x1 mesh, gives the plain prefill's logits and cache bit
    for bit."""
    cfg = get_config("llama3-3b").reduced().replace(ref_attention="chunked")
    model = build_model(cfg)
    toks = long_tokens(cfg, 2)
    with torch.no_grad():
        plain = list(tree_tensors(model.prefill(
            model.init(torch.Generator().manual_seed(0)), toks,
            max_len=CHUNKED_SEQ)))
    _one_rank_group()
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad(), implicit_replication():
            out = model.prefill(
                with_sharding(params, param_pspecs(params, mesh), mesh),
                with_sharding(toks, batch_pspec(mesh, 2), mesh),
                max_len=CHUNKED_SEQ)
        placed = [t.full_tensor() for t in tree_tensors(out)]
    finally:
        dist.destroy_process_group()
    assert len(placed) == len(plain)
    assert all(torch.equal(a, b) for a, b in zip(placed, plain))
