"""The port's examples (``examples/torch_*.py``), on the CPU at a small size.

The four numpy-stack scripts are the originals with ``repro`` rewritten to
``repro_torch``: each function, run at a small size on the same arguments
as the original's (a request count cut where the script fixes it), must
return, or print, exactly what the original does. The training script runs
a cut-down model for a few steps with ``--device cpu``.
"""
import importlib.util
import math
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(name):
    return load(name), load(f"torch_{name}")


def test_quickstart_serves_as_the_original():
    ref, port = both("quickstart")
    assert port.serve(n=120, seed=7) == ref.serve(n=120, seed=7)
    tuned = [m.serve(policy=m.get_policy("agft"), n=120, seed=7)
             for m in (ref, port)]
    assert tuned[0] == tuned[1]


def test_serve_agft_runs_as_the_original():
    ref, port = both("serve_agft")
    out = []
    for m in (ref, port):
        eng, tuner = m.run(120.0, 3.0, 11, True, report_every=60.0)
        c = eng.metrics.c
        out.append((c.energy_joules_total, len(eng.finished),
                    [r.ttft for r in eng.finished],
                    [h["freq"] for h in tuner.history]))
    assert out[0] == out[1]


def _cut_requests(monkeypatch, mod, n_max):
    real = mod.generate_requests

    def cut(proto, n, **kw):
        return real(proto, min(n, n_max), **kw)
    monkeypatch.setattr(mod, "generate_requests", cut)


def test_multi_arch_serving_prints_as_the_original(monkeypatch, capsys):
    printed = []
    for m in both("multi_arch_serving"):
        _cut_requests(monkeypatch, m, 60)
        m.main()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert len(printed[0].splitlines()) == 1 + len(load(
        "torch_multi_arch_serving").ARCHS)


def test_cluster_serving_prints_as_the_original(monkeypatch, capsys):
    printed = []
    for m in both("cluster_serving"):
        real = m.trace
        monkeypatch.setattr(m, "trace", lambda real=real: real(n=60))
        m.main()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "fleet energy" in printed[1] and "global fleet" in printed[1]


def test_train_tinyllama_runs_on_the_cpu(monkeypatch, tmp_path):
    port = load("torch_train_tinyllama")
    small = port.config_120m().replace(num_layers=2, d_model=128,
                                       num_heads=4, num_kv_heads=2,
                                       head_dim=32, d_ff=256,
                                       vocab_size=512)
    monkeypatch.setattr(port, "config_120m", lambda: small)
    ckpt = str(tmp_path / "ckpt.npz")
    hist = port.main(["--device", "cpu", "--steps", "10", "--batch", "4",
                      "--seq", "32", "--checkpoint", ckpt])
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert os.path.getsize(ckpt) > 0


def test_train_tinyllama_asks_for_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        load("torch_train_tinyllama").main(["--steps", "1"])
