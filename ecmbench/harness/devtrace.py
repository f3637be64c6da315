"""The device trace of a window: torch.profiler's kernel intervals, read
as chip_smoke.py's profile_job reads them (copied here): each card's busy
time is the union of its device operations' intervals, and its idle share
1 - busy / window.  Each stretch of an idle gap is labelled by the
innermost host span (torch.profiler.record_function, named
"ecmbench:<phase>") that covers it."""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Tuple

SPAN_PREFIX = "ecmbench:"
WINDOW_SPAN = SPAN_PREFIX + "window"


@dataclasses.dataclass
class DeviceTrace:
    window_s: float                  # the traced window, host clock
    busy_s: float                    # union of device intervals, mean a card
    devices: int
    kernels: Dict[str, Tuple[int, float]]   # name -> (count, seconds)
    idle_gaps: Dict[str, float]      # host span -> idle seconds, mean a card

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches pattern,
        summed over the cards."""
        rx = re.compile(pattern)
        return sum(s for name, (_c, s) in self.kernels.items()
                   if rx.search(name))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short_name(n), s] for n, (_c, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:96]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(prof, window_s: float, devices: int) -> DeviceTrace:
    """The DeviceTrace of a finished torch.profiler.profile whose window
    ran inside a record_function(WINDOW_SPAN)."""
    from torch.autograd import DeviceType
    dev: Dict[int, List[Tuple[float, float]]] = {}
    kernels: Dict[str, List] = {}
    spans: List[Tuple[float, float, str]] = []
    lo = hi = None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and e.name.startswith(
                SPAN_PREFIX):
            continue   # the spans' own marks on the device's timeline
        if e.device_type == DeviceType.CUDA:
            if b <= a:
                continue
            dev.setdefault(e.device_index, []).append((a, b))
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e6
        elif e.name.startswith(SPAN_PREFIX):
            if e.name == WINDOW_SPAN:
                lo, hi = a, b
            else:
                spans.append((a, b, e.name[len(SPAN_PREFIX):]))
    # nested spans, outer first where two start together: the innermost
    # that covers t is the last to start at or before t among those that
    # end at or after it
    spans.sort(key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    cuts = sorted({t for s in spans for t in s[:2]})

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if spans[i][1] >= t:
                return spans[i][2]
            i -= 1
        return "between batches"

    busy = 0.0
    gaps: Dict[str, float] = {}
    for iv in dev.values():
        merged = _union(iv)
        if lo is not None:
            merged = [(max(a, lo), min(b, hi)) for a, b in merged
                      if b > lo and a < hi]
        busy += sum(b - a for a, b in merged) / 1e6
        if lo is None:
            continue
        edges = [lo] + [t for ab in merged for t in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            # a gap's pieces between span edges, each by its own span
            i, j = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
            pts = [a] + cuts[i:j] + [b]
            for x, y in zip(pts, pts[1:]):
                if y > x:
                    name = label((x + y) / 2)
                    gaps[name] = gaps.get(name, 0.0) + (y - x) / 1e6
    n = max(devices, 1)
    return DeviceTrace(window_s=window_s, busy_s=busy / n, devices=devices,
                       kernels={k: (c, s) for k, (c, s) in kernels.items()},
                       idle_gaps={k: v / n for k, v in gaps.items()})
