"""Host spans of a run: the one record of where the driver's time goes.

`with rec.span(key):` adds the block's seconds to rec.timings[key]
(ECMDriver.timings, RunResult.timings) and, with the log on, appends
(key, parent key, start ns, end ns) to rec.log.  A span's parent is the
span open on the same thread when it began, None at a thread's top: the
stage-2 planner thread's spans never nest under the main thread's.  A
span must close on the thread and in the order it opened, so none is
held open across a generator's yield.

Spans start and end on time.time_ns(), the clock torch.profiler stamps
its events with (an event's absolute time is
prof.profiler.kineto_results.trace_start_ns() + time_range * 1000 ns), so
a span log lines up with a device trace of the same run.  The recorder
emits no profiler marks: a record_function span around GPU work is drawn
on the device's timeline too, where it would read as busy time.

Each key is written from one thread only, so the read-modify-write of
rec.timings needs no lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# (key, parent key or None, start ns, end ns) on time.time_ns()
Span = Tuple[str, Optional[str], int, int]


class SpanRecorder:
    def __init__(self, timings: Optional[Dict[str, float]] = None,
                 log: bool = False):
        self.timings: Dict[str, float] = {} if timings is None else timings
        self.log: List[Span] = []
        self.logging = log
        self._local = threading.local()

    def span(self, key: str) -> "_Span":
        return _Span(self, key)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    __slots__ = ("rec", "key", "parent", "t0")

    def __init__(self, rec: SpanRecorder, key: str):
        self.rec, self.key = rec, key

    def __enter__(self) -> "_Span":
        if self.rec.logging:
            stack = self.rec._stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.key)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        rec, key = self.rec, self.key
        rec.timings[key] = rec.timings.get(key, 0.0) + (t1 - self.t0) / 1e9
        if rec.logging:
            rec._stack().pop()
            rec.log.append((key, self.parent, self.t0, t1))
