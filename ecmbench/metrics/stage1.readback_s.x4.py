"""stage1.readback_s.x4: stage1.readback_s (metrics/stage1.readback_s.py) in the four-card cell, where it
moves curves_per_s.x4: the same reading over the four cards' window."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "ecmbench_metric_stage1_readback_s_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "stage1.readback_s.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
