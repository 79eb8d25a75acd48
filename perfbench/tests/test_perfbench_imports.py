"""The import check: nothing the harness runs loads JAX or the JAX
package, and the reference loads nothing of the program (nor torch),
by top-level module names compared whole."""

import ast
import os
import subprocess
import sys

from perfbench.harness import bench, registry

PERFBENCH = registry.PERFBENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "stark_mlwe_tpu"}


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(sub=""):
    for d, _, fs in os.walk(os.path.join(PERFBENCH, sub)):
        if os.sep + "tests" in d:
            continue
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not FORBIDDEN & set(_top_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = set(_top_imports(path))
        assert not tops & (FORBIDDEN | {"stark_mlwe_tpu_torch", "torch"}), \
            path


def test_the_run_time_check_compares_whole_top_level_names():
    assert bench.forbidden_modules(
        ["stark_mlwe_tpu_torch", "stark_mlwe_tpu_torch.fri", "jaxtyping",
         "numpy"]) == []
    assert bench.forbidden_modules(
        ["jax", "jax._src.core", "jaxlib.xla", "flax", "stark_mlwe_tpu",
         "stark_mlwe_tpu.spec"]) == sorted(
        ["jax", "jax._src.core", "jaxlib.xla", "flax", "stark_mlwe_tpu",
         "stark_mlwe_tpu.spec"])


def _loaded_by(code):
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=os.path.dirname(PERFBENCH), check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    return set(out.stdout.split())


def test_loaded_modules_of_the_harness_and_the_reference():
    reference = _loaded_by(
        "import sys; sys.path.insert(0, '.');"
        "import perfbench.reference.stark, perfbench.reference.nizk_mf;"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    assert not reference & (FORBIDDEN | {"stark_mlwe_tpu_torch", "torch"})
    harness = _loaded_by(
        "import sys; sys.path.insert(0, '.');"
        "from perfbench.harness import bench, cli, registry;"
        "b = registry.load_benchmark();"
        "[registry.system(c['system']) for c in "
        " (registry.config(b, x['name']) for x in b['configs'])];"
        "[registry.metric_reader(m['name']) for m in b['per_layer']];"
        "import stark_mlwe_tpu_torch.fri, stark_mlwe_tpu_torch.channel;"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    assert not harness & FORBIDDEN
    assert "stark_mlwe_tpu_torch" in harness
