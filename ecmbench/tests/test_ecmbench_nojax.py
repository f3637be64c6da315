"""No module of JAX or of the JAX package in the benchmark, compared by
whole top-level names; nothing of the program in its reference."""

import ast
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "tpu_ecm"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(sub=""):
    top = os.path.join(ebhelp.BENCH, sub)
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_import_no_jax():
    for path in _sources():
        assert not set(_imports(path)) & BANNED, path


def test_whole_names_compared():
    # the port's name begins with the JAX package's: only whole names count
    assert "tpu_ecm_torch".split(".", 1)[0] not in BANNED


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert not names & (BANNED | {"tpu_ecm_torch", "torch"}), path


def test_run_loads_no_jax():
    code = ("import sys, time; sys.path[:0] = [%r, %r]\n"
            "import ebhelp\n"
            "ebhelp.run_tiny(ebhelp.tiny_cell())\n"
            "from harness import runner\n"
            "print(runner.jax_modules())\n"
            % (os.path.dirname(os.path.abspath(__file__)), ebhelp.BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
