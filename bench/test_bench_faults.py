"""Whole runs of small copies of the cells on the CPU, the look for a
card skipped: a sound run comes out correct, and each fault that a cell
can have, planted in the timed path underneath, comes out not correct."""
import functools

import pytest
import torch

from bench import check, control, run
from bench.small import small_cell
from repro_torch.models.common import tree_clone

CELLS = ["deepseek-v2-lite-16b.normal", "mamba2-1.3b.chat"]
SEED = 2**31 + 101


def _run(name, prepare=None):
    return run.run_cell(name, SEED, 1.0, False, "cpu",
                        cell=small_cell(name), prepare=prepare)


def _wrap(backend, after):
    """The decode step's body, its result passed through ``after(logits,
    cache, before)`` (``before``: the cache as the step found it)."""
    g = backend.decode_graph
    f = g.fn

    def step():
        before = tree_clone(f.args[3])
        return after(f(), f.args[3], before)
    g.fn = step


def _state_unchanged(backend):
    g = backend.decode_graph
    f = g.fn
    g.fn = lambda: f.func(*f.args[:3], tree_clone(f.args[3]), f.args[4])


def _half_batch(backend):
    def after(logits, cache, before):
        for new, old in zip(_leaves(cache), _leaves(before)):
            b = new.shape[_row_dim(new)]
            new.narrow(_row_dim(new), b // 2, b - b // 2).copy_(
                old.narrow(_row_dim(old), b // 2, b - b // 2))
        b = logits.shape[0]
        logits[b // 2:] = logits[:b - b // 2]
        return logits
    _wrap(backend, after)


def _token_altered(backend):
    def after(logits, cache, before):
        row = logits[0, -1]
        row[row.argmin()] = row.max() + 1.0
        return logits
    _wrap(backend, after)


def _leaves(cache):
    from repro_torch.models.common import tree_tensors
    return list(tree_tensors(cache))


def _row_dim(t):
    # a stacked leaf holds (layers, rows, ...); a prefix layer's (rows, ...)
    return 1 if t.dim() >= 4 or (t.dim() == 3 and t.shape[0] > 8) else 0


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    limits = small_cell(name).limits
    assert set(res["check"]) >= set(limits) - {"prefill_err"}
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault):
    res = _run(name, prepare=fault)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_a_miscount_is_not_correct(name):
    def prepare(backend):
        f = backend.execute

        @functools.wraps(f)
        def execute(plan, f_mhz):
            if plan.decode:
                plan.decode[-1].generated += 1      # a token counted twice
            return f(plan, f_mhz)
        backend.execute = execute
    res = _run(name, prepare=prepare)
    assert not res["correct"] and res["check"]["tokens_miscounted"][
        "value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The fp8 reference in the program's place fails the cell's limits,
    where the program passes them, over the same inputs."""
    cell = small_cell(name, control=True)
    out = control.readings(name, [SEED, SEED + 1], 2, 1.0, "cpu", cell=cell)
    limits = cell.limits
    model = [k for k in limits if k != "tokens_miscounted"]
    for k in model:
        assert out["lower"][k] is None or out["lower"][k] <= limits[k]
    assert any(out["upper"][k] is not None and out["upper"][k] > limits[k]
               for k in model)
