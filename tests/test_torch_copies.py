"""The port's copies of the JAX package's numpy-stack and config modules
are the reference's code: each module listed here, and each function
listed, parses (``ast.dump``, docstrings stripped) to the same tree as its
``src/repro`` source with ``repro.`` rewritten to ``repro_torch.`` (and an
import of ``repro`` itself to one of ``repro_torch``), as ``sed`` would
rewrite it. So does each of the reference's unit-test files of those
modules listed here against its ``tests/test_torch_*.py`` copy. Sources
are read as text; nothing is imported.
"""
import ast
import os
import re

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")

# every module of repro_torch that is its repro namesake with the prefix
# rewritten
COPIED_MODULES = [
    "configs.chameleon_34b", "configs.deepseek_v2_lite_16b",
    "configs.llama3_3b", "configs.llama4_scout_17b_a16e",
    "configs.mamba2_1p3b", "configs.nemotron_4_15b",
    "configs.phi3_medium_14b", "configs.recurrentgemma_9b",
    "configs.shapes", "configs.starcoder2_7b", "configs.tinyllama_1p1b",
    "configs.whisper_medium",
    "core.__init__", "core.features", "core.linucb", "core.monitor",
    "core.page_hinkley", "core.pruning", "core.refinement", "core.reward",
    "core.stacked", "core.tuner", "core.tuner2d",
    "data.__init__", "data.pipeline",
    "energy.costs", "energy.edp", "energy.phases", "energy.power_model",
    "launch.serve", "models.registry",
    "policies.__init__", "policies.agft", "policies.base", "policies.fixed",
    "policies.fleet", "policies.hierarchy", "policies.phased",
    "policies.registry", "policies.rules",
    "serving.cluster", "serving.driver", "serving.faults",
    "serving.fleet_step", "serving.kv_cache", "serving.metrics",
    "serving.network", "serving.request", "serving.scheduler",
    "training.__init__",
    "workloads.__init__", "workloads.azure_trace", "workloads.prototypes",
]

# functions copied into modules of the port's own
COPIED_FUNCTIONS = [
    ("launch.dryrun", "collective_bytes"),
    ("launch.dryrun", "_scan_length"),
    ("distributed.sharding", "_param_rule"),
]

# the reference's unit tests of the numpy stack, each copied as
# tests/test_torch_<name>.py
COPIED_TESTS = ["agft_core", "serving", "vectorized_hotpath", "property"]


def _path(package, module):
    return os.path.join(SRC, package, *module.split(".")) + ".py"


def _rewritten(text):
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    return re.sub(r"^(\s*(?:from|import) )repro\b(?!_)", r"\1repro_torch",
                  text, flags=re.M)


def _tree(text):
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _read(package, module):
    with open(_path(package, module)) as f:
        return f.read()


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_module_is_the_reference_with_the_prefix_rewritten(module):
    ref = _tree(_rewritten(_read("repro", module)))
    port = _tree(_read("repro_torch", module))
    assert ast.dump(port) == ast.dump(ref)


def _function(tree, name):
    (fn,) = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


@pytest.mark.parametrize("module,name", COPIED_FUNCTIONS)
def test_function_is_the_reference_with_the_prefix_rewritten(module, name):
    ref = _function(_tree(_rewritten(_read("repro", module))), name)
    port = _function(_tree(_read("repro_torch", module)), name)
    assert ast.dump(port) == ast.dump(ref)


@pytest.mark.parametrize("name", COPIED_TESTS)
def test_test_file_is_the_reference_with_the_prefix_rewritten(name):
    with open(os.path.join(TESTS, f"test_{name}.py")) as f:
        ref = _tree(_rewritten(f.read()))
    with open(os.path.join(TESTS, f"test_torch_{name}.py")) as f:
        port = _tree(f.read())
    assert ast.dump(port) == ast.dump(ref)
