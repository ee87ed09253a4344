"""BENCHMARK.json against the contract it is written to, and every piece
it names found by name."""
import json
import re

import pytest

from bench.cell import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"] and 1 <= M["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(M)) < 64 * 1024


def test_bounds_and_sources():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in M["end_to_end"] if _reports(m, cell)}
    layer = [m for m in M["per_layer"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)


def test_layers_are_named_alike():
    for m in M["per_layer"]:
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200


def test_every_piece_is_found_by_name():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used, c["name"]
        f = ROOT / c["file"]
        assert f.is_file() and f.with_suffix(".py").is_file()
        assert c["file"].startswith("bench/")
        spec = json.loads(f.read_text())
        assert spec["source"] == c["source"]
        assert sorted(spec["reduced"]) == sorted(c["reduced"])
    for w in M["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_config_file_states_the_widths_it_runs(name):
    (c,) = [c for c in M["configs"] if c["name"] == name]
    spec = json.loads((ROOT / c["file"]).read_text())
    m = spec["model_config"]
    if "hidden_size" in spec:
        pairs = [("hidden_size", "d_model"), ("num_hidden_layers",
                 "num_layers"), ("num_attention_heads", "num_heads"),
                 ("intermediate_size", "d_ff"),
                 ("moe_intermediate_size", "moe_d_ff"),
                 ("n_routed_experts", "num_experts"),
                 ("num_experts_per_tok", "top_k"),
                 ("n_shared_experts", "num_shared_experts"),
                 ("first_k_dense_replace", "first_k_dense"),
                 ("kv_lora_rank", "kv_lora_rank"),
                 ("qk_nope_head_dim", "qk_nope_head_dim"),
                 ("qk_rope_head_dim", "qk_rope_head_dim"),
                 ("v_head_dim", "v_head_dim"), ("vocab_size", "vocab_size"),
                 ("rms_norm_eps", "norm_eps"), ("rope_theta", "rope_theta")]
    else:
        pairs = [("d_model", "d_model"), ("n_layer", "num_layers"),
                 ("d_state", "ssm_state"), ("d_conv", "conv_kernel"),
                 ("expand", "ssm_expand"), ("headdim", "ssm_head_dim"),
                 ("ngroups", "ssm_ngroups")]
        # the published ids padded to the rows that mamba_ssm builds
        pad = spec["pad_vocab_size_multiple"]
        assert m["vocab_size"] == -(-spec["vocab_size"] // pad) * pad
    for a, b in pairs:
        assert spec[a] == m[b], (a, b)


def test_limits_hold_every_number():
    from bench.check import NUMBERS
    for w in M["workloads"]:
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json")
                         .read_text())
        assert set(lim) <= set(NUMBERS)
        assert lim["tokens_miscounted"] == 0 and len(lim) >= 3
