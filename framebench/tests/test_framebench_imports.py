"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and
the reference imports nothing of the program. Top-level names compare
whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from framebench.harness import main, spec

BANNED = {"jax", "jaxlib", "flax", "drts_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    top = os.path.join(spec.ROOT, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] not in {"drts_tpu_torch", "framebench"}
            assert name.split(".")[0] not in BANNED


def test_banned_names_compare_whole():
    assert main.BANNED == ("jax", "jaxlib", "flax", "drts_tpu")
    sys.modules.setdefault("drts_tpu_torch_lookalike", sys)
    assert "drts_tpu_torch_lookalike" not in main.banned_modules()


def test_loading_everything_the_benchmark_runs_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib, pkgutil\n"
        "import framebench.harness as h, framebench.reference as r\n"
        "for pkg in (h, r):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "from framebench.harness import main, spec\n"
        "import json\n"
        "for w in json.load(open(%r))['workloads']:\n"
        "    main.readers_of(spec.load_cell(w['name']))\n"
        "import drts_tpu_torch.session, drts_tpu_torch.parallel.multihost\n"
        "import drts_tpu_torch.models.myscene\n"
        "print(main.banned_modules())\n" % (
            spec.REPO, os.path.join(spec.REPO, "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
