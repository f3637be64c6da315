"""The machine with the GPU has no JAX: every module of tpu_ecm_torch (and
chip_smoke.py) must import, and the CLI must run, with `import jax`
failing."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N71 = 34359738421 * 68719476767

CODE = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
import tpu_ecm_torch
for m in pkgutil.walk_packages(tpu_ecm_torch.__path__, "tpu_ecm_torch."):
    if m.name != "tpu_ecm_torch.__main__":
        importlib.import_module(m.name)
from tpu_ecm_torch.io import cli
rc = cli.main(["-device", "cpu", "{N71}", "4", "300", "0", "10000", "110"])
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k == "jax" or k.startswith(("jax.", "jaxlib")))]
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
