"""What the benchmark loads: never JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
a reference that takes nothing of the program."""

import ast
import os
import subprocess
import sys

from perfbench import harness

PKG = os.path.join(harness.ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "dbaf_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        got = _imports(path)
        assert not (got & (FORBIDDEN | {"dbaf_tpu_torch", "perfbench"})), (path, got)


def test_loading_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from perfbench import harness, check, capture, counts, scene, trace, weights;"
        "import json, os;"
        "b = json.load(open(os.path.join(sys.argv[1], 'BENCHMARK.json')));"
        "[harness.load_reader(m['name']) for m in b['end_to_end'] + b['per_layer']];"
        "import dbaf_tpu_torch.slam.system, dbaf_tpu_torch.models.net;"
        "print(harness.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dbaf_tpu_torch_fake_probe", sys)
    assert "dbaf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in harness.forbidden_modules()


def test_nothing_reads_the_old_bench_or_smoke_files():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        for name in ("bench.py", "chip_smoke", "BENCH_r0", "tools/"):
            # copies name their origin in the docstring; no code opens these
            for line in text.splitlines():
                s = line.strip()
                if name in s and not s.startswith(("#", "*", "``", "(")) and "open(" in s:
                    raise AssertionError(f"{path} reads {name}")
