"""No run may load JAX or the JAX package, and the reference imports
nothing of the program either."""

import ast
import os

import pytest

import run

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub):
    d = os.path.join(BENCH_DIR, sub)
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".py")]


@pytest.mark.parametrize("names, bad", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["neural_renderer_tpu", "neural_renderer_tpu.ops.rng"],
     ["neural_renderer_tpu"]),
    (["neural_renderer_tpu_torch", "neural_renderer_tpu_torch.ops.rng"], []),
    (["jaxtyping", "jax_utils", "neural_renderer_tpu2"], []),
])
def test_whole_name_check(names, bad):
    assert run.forbidden_modules(names) == bad


@pytest.mark.parametrize("sub", ["reference", "harness", "layers",
                                 "end_to_end", "."])
def test_no_source_imports_jax(sub):
    for path in _sources(sub):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "neural_renderer_tpu_torch" not in tops, path
        assert tops <= {"__future__", "dataclasses", "typing", "json", "os",
                        "math", "numpy", "torch"}, (path, tops)
