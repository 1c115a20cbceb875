"""Nothing the benchmark runs may load JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the
program."""
import ast
import os
import subprocess
import sys

from portbench.harness import env, spec


def test_the_check_compares_whole_top_level_names():
    loaded = {"montecarlo_pathtracing_tpu_torch",
              "montecarlo_pathtracing_tpu_torch.models.megakernel",
              "numpy", "jaxtyping", "flaxen.x"}
    assert env.forbidden_modules(loaded) == []
    assert env.forbidden_modules(loaded | {"jax.numpy"}) == ["jax"]
    assert env.forbidden_modules(loaded | {"jaxlib", "flax.linen"}) == [
        "flax", "jaxlib"]
    assert env.forbidden_modules(
        loaded | {"montecarlo_pathtracing_tpu.render.renderer"}) == [
        "montecarlo_pathtracing_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_neither_the_program_nor_jax():
    ref = os.path.join(spec.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref,
                                                                   name))}
            assert not tops & {"montecarlo_pathtracing_tpu_torch",
                               "montecarlo_pathtracing_tpu", "jax",
                               "portbench"}, name


def test_a_harness_process_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.harness.cell, portbench.harness.port as p;"
            "p.launches(); import portbench.reference;"
            "from portbench.harness import env;"
            "print(env.forbidden_modules())") % spec.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
