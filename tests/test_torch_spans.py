"""The driver's host spans (tpu_ecm_torch/utils/spans.py): every timings
key of a run, their nesting by thread, their clock against
torch.profiler's, and the benchmark's program_span metrics that read
them.

The card test (marker `cuda`) runs from the repository root without the
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spans.py
"""

import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.utils.spans import SpanRecorder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P35, P36 = 34359738421, 68719476767
N71 = P35 * P36
# each key's parent span (None: the top of its thread); harvest and
# savefile nest under whatever is open, the batch or stage 1's checkpoint
PARENTS = {
    "batch": {None},
    "build": {"batch"}, "stage1": {"batch"},
    "stage2_init": {"batch"}, "stage2": {"batch"},
    "harvest": {"batch", "stage1"}, "savefile": {"batch", "stage1"},
    "build_curves": {"build"}, "pack": {"build"},
    "stage1_wait": {"stage1"}, "stage1_readback": {"stage1"},
    "stage2_wait": {"stage2_init", "stage2"},
    "stage2_convert": {"stage2_init", "stage2"},
    "stage2_modinv": {"stage2_init", "stage2"},
    "stage2_plan_wait": {"stage2"},
    "stage2_sieve": {None}, "stage2_pair": {None},
}
# the counters of these runs before the recorder existed, equal to
# tpu_ecm's (the parity tests hold the port's counters to tpu_ecm's)
COUNTERS = {"ptadds": 1459, "ptdups": 153, "numprimes": 62, "paired": 147,
            "numinv": 3}

torch.set_num_threads(1)


def _cfg(tmp_path, **kw):
    kw.setdefault("save_b1_path", str(tmp_path / "save_b1.txt"))
    kw.setdefault("checkpoint_path", str(tmp_path / "checkpoint.txt"))
    kw.setdefault("results_path", str(tmp_path / "ecm_results.txt"))
    for k, v in dict(n=N71, curves=4, sigma=110, verbose=0, device="cpu",
                     stop_on_factor=False, cache_dir=None).items():
        kw.setdefault(k, v)
    return driver.RunConfig(**kw)


@pytest.fixture(scope="module", params=["digit", "rns"])
def logged_run(request, tmp_path_factory):
    """A two-stage N71 run of 4 curves with the span log on."""
    tmp = tmp_path_factory.mktemp(request.param)
    drv = driver.ECMDriver(_cfg(tmp, b1=300, b2=2000, engine=request.param,
                                span_log=True))
    return drv, drv.run()


def test_every_key_and_parent_sums(logged_run):
    drv, res = logged_run
    t = res.timings
    assert set(t) == set(PARENTS)
    assert all(v >= 0 for v in t.values())
    assert res.counters == COUNTERS
    assert {(h.factor, h.stage, h.sigma) for h in res.factors} \
        == {(P35, 2, 112), (P36, 2, 111)}
    # a parent's time covers its children's (one stage-1 chunk: no
    # checkpoint, so harvest and savefile sit under batch alone)
    eps = 1e-3
    for parent in ("batch", "build", "stage1"):
        kids = [k for k, ps in PARENTS.items() if ps == {parent}
                or (parent == "batch" and k in ("harvest", "savefile"))]
        assert t[parent] >= sum(t[k] for k in kids) - eps, parent
    crossings = ("stage2_wait", "stage2_convert", "stage2_modinv",
                 "stage2_plan_wait")
    assert t["stage2_init"] + t["stage2"] \
        >= sum(t[k] for k in crossings) - eps


def test_span_log_nests(logged_run):
    drv, res = logged_run
    log = drv.span_log
    assert {k for k, _p, _a, _b in log} == set(PARENTS)
    for key, parent, a, b in log:
        assert a <= b and parent in PARENTS[key], (key, parent)
        if parent is not None:
            # inside a span of its parent's key
            assert any(k == parent and pa <= a and b <= pb
                       for k, _pp, pa, pb in log), (key, parent)
    sums = {}
    for key, _p, a, b in log:
        sums[key] = sums.get(key, 0) + (b - a) / 1e9
    assert sums == pytest.approx(res.timings, abs=1e-6)


def test_span_log_off_is_empty(tmp_path):
    drv = driver.ECMDriver(_cfg(tmp_path, curves=2, b1=20, b2=20,
                                engine="rns"))
    res = drv.run()
    assert drv.span_log == [] and res.timings["stage1"] > 0
    assert {"batch", "build", "pack", "stage1_readback"} <= set(res.timings)


def test_spans_nest_per_thread():
    """Spans of threads run side by side nest under their own thread's
    spans only, and each thread's keys sum apart."""
    rec = SpanRecorder(log=True)
    gate = threading.Barrier(3, timeout=30)

    def work(name):
        with rec.span(name):
            gate.wait()
            with rec.span(name + "_inner"):
                gate.wait()

    with rec.span("main"):
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for th in threads:
            th.start()
        gate.wait()
        with rec.span("main_inner"):
            gate.wait()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    parents = {k: p for k, p, _a, _b in rec.log}
    assert parents == {"a": None, "b": None, "main": None,
                       "a_inner": "a", "b_inner": "b",
                       "main_inner": "main"}
    assert set(rec.timings) == set(parents)
    off = SpanRecorder()
    with off.span("x"):
        pass
    assert off.log == [] and set(off.timings) == {"x"}


def test_stage1_span_on_profiler_clock(tmp_path):
    """The span log and torch.profiler share one clock: stage 1's span,
    placed on the trace through trace_start_ns() + time_range, covers
    every aten op of stage 1's plain tape within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    drv = driver.ECMDriver(_cfg(tmp_path, curves=2, b1=20, b2=20,
                                engine="rns", span_log=True))
    ops = drv.shard_ops[0]
    tape = ops.tape
    mark = "test:stage1_tape"

    def marked(*a, **k):
        with record_function(mark):
            return tape(*a, **k)

    ops.tape = marked
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.run()
    base = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    marks = [e for e in events if e.name == mark]
    assert marks
    aten = [(base + e.time_range.start * 1000, base + e.time_range.end * 1000)
            for e in events if e.name.startswith("aten::")
            and any(m.time_range.start <= e.time_range.start
                    and e.time_range.end <= m.time_range.end
                    for m in marks)]
    assert aten
    (lo, hi), = [(a, b) for k, _p, a, b in drv.span_log if k == "stage1"]
    ms = 1_000_000
    assert lo - ms <= min(a for a, _b in aten)
    assert max(b for _a, b in aten) <= hi + ms


@pytest.fixture(scope="module")
def harness_view():
    """What the benchmark's metrics read (harness/runner.RunView) after a
    tiny CPU run of its harness (ecmbench/tests/ebhelp.py) over four CPU
    shards, as the x4 cell splits its batch; the spans' readers see
    nothing that depends on the shard count."""
    sys.path.insert(0, os.path.join(ROOT, "ecmbench", "tests"))
    import ebhelp
    from harness import runner

    tiny = ebhelp.tiny_cell("rns", devices=4)
    # shorter bounds than the harness's own tests take: a reading, not
    # the judge, is checked here
    tiny.traffic.update(b1=100, b2=1000)
    return runner.measure(tiny, ebhelp.SEED, 0.01, False, 0.0,
                          device="cpu")["view"]


@pytest.mark.parametrize("cell", ["c124.b2x100", "c124.b2x100.x4"])
def test_program_span_metrics_read(cell, harness_view):
    """Each program_span metric of the cell, the accepted ones and the
    readers of this port's span keys, reads a number: the window's timings
    have every key the readers look for."""
    from harness import spec

    metrics = [m["name"] for m in spec.find_cell(ROOT, cell).per_layer
               if m["source"] == "program_span"]
    assert {"stage1.readback_s", "stage2.host_s"} <= {
        m.removesuffix(".x4") for m in metrics}
    for name in metrics:
        value = spec.metric_reader(name).read(harness_view)
        assert value is not None and value >= 0, name


@pytest.mark.cuda
def test_stage1_wait_ends_after_last_tape_kernel(tmp_path):
    """On the card, stage1_wait ends within 1 ms after the batch's last K1
    kernel ends, in the device trace of one small batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from torch.profiler import ProfilerActivity, profile

    kw = dict(curves=2048, b1=20000, b2=20000, engine="digit",
              device="cuda", span_log=True)
    driver.ECMDriver(_cfg(tmp_path, **kw)).run()      # builds, loads K1
    drv = driver.ECMDriver(_cfg(tmp_path, **kw))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.run()
    base = prof.profiler.kineto_results.trace_start_ns()
    ends = [base + e.time_range.end * 1000 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "tape_lanes_kernel" in e.name]
    assert ends
    (end,), = [(b,) for k, _p, _a, b in drv.span_log if k == "stage1_wait"]
    assert max(ends) <= end <= max(ends) + 1_000_000
