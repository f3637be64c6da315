"""The machine with the GPU has no JAX, and the port imports nothing of the
JAX package: every module of tpu_ecm_torch (and chip_smoke.py) must import,
and the CLI must run to the N71 stage-2 find and resume its save_b1.txt to
the same find (-resume), with `import jax` and `import tpu_ecm` failing;
and no source line of the port imports either."""

import glob
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N71 = 34359738421 * 68719476767

CODE = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["tpu_ecm"] = None      # and any `import tpu_ecm...`
import torch
torch.set_num_threads(1)
import chip_smoke
import tpu_ecm_torch
for m in pkgutil.walk_packages(tpu_ecm_torch.__path__, "tpu_ecm_torch."):
    if m.name != "tpu_ecm_torch.__main__":
        importlib.import_module(m.name)
from tpu_ecm_torch.io import cli
rc = cli.main(["-device", "cpu", "{N71}", "4", "300", "0", "10000", "110"])
rc = rc or cli.main(["-device", "cpu", "-resume", "save_b1.txt", "10000"])
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k == "jax" or k.startswith(("jax.", "jaxlib"))
                                or k == "tpu_ecm" or k.startswith("tpu_ecm."))]
assert not loaded, loaded
sys.exit(rc)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", CODE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "found PRP11 factor 34359738421 in stage 2" in res.stdout
    assert (tmp_path / "save_b1.txt").exists()
    assert ("final: PRP11 factor 34359738421 (stage 2, sigma 112)\n"
            "resumed 4 curves") in res.stdout


IMPORT_RE = re.compile(r"^\s*(from\s+(tpu_ecm|jax|jaxlib)(\.|\s)"
                       r"|import\s+(tpu_ecm|jax|jaxlib)(\.|\s|,|$))")


def test_no_source_line_imports_jax_or_tpu_ecm():
    """A scan of tpu_ecm_torch/**/*.py and chip_smoke.py: no line imports
    jax or the JAX package (tpu_ecm_torch itself is fine)."""
    files = glob.glob(os.path.join(REPO, "tpu_ecm_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if IMPORT_RE.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: "
                               f"{line.strip()}")
    assert not bad, bad
    assert IMPORT_RE.match("from tpu_ecm.params import MontyCtx")
    assert IMPORT_RE.match("    import tpu_ecm")
    assert not IMPORT_RE.match("from tpu_ecm_torch import driver")
