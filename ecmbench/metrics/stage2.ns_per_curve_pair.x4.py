"""stage2.ns_per_curve_pair.x4: stage2.ns_per_curve_pair (metrics/stage2.ns_per_curve_pair.py) in the four-card cell, where it
moves curves_per_s.x4: the same reading over the four cards' window."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "ecmbench_metric_stage2_ns_per_curve_pair_base",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "stage2.ns_per_curve_pair.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
