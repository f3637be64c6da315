"""stage2.host_s.x4: stage2.host_s (metrics/stage2.host_s.py) in the four-card cell, where it
moves curves_per_s.x4: the same reading over the four cards' window."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "ecmbench_metric_stage2_host_s_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "stage2.host_s.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
