"""The curve axis split over several devices (tpu_ecm_torch.parallel.mesh.
Sharder, RunConfig.sharder) held against tpu_ecm's Sharder: the Sharder's
own contract, and the REDC digit engine's run of N71 = P35*P36 (8 curves
from sigma 110, B1=300) sharded over k = 1, 2, 3 CPU devices against
tpu_ecm sharded over as many virtual CPU devices (tests/conftest.py): the
same factor list (factor, stage, curve, sigma, in report order),
stage-1 residues, curves_run (rounded to whole shards: 9 at k = 3),
save_b1.txt, checkpoint.txt and ecm_results.txt bytes and counters.

Each job runs twice: to B2=10000 in one prime chunk (sigma 112 finds P35
and sigma 111 P36 in stage 2), and stage 1 alone with prime_chunk=100
(two checkpoints).  A chunked run to B2=10000 would walk stage 2 in 97
chunks, each chaining a whole 512-row Pa group through the plain
versions: minutes on this CPU.  The RNS engine's twin of these runs is
tests/test_torch_parallel_rns.py; Edwards is in
tests/test_torch_parallel_paths.py, the fold in _fold.py, noinv and a
replay mode in _stage2.py, resume_stage2 in _resume.py."""

import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpu_ecm import driver as j_driver  # noqa: E402
from tpu_ecm.parallel import Sharder as JSharder  # noqa: E402
from tpu_ecm_torch import driver  # noqa: E402
from tpu_ecm_torch.limbs import kernels  # noqa: E402
from tpu_ecm_torch.parallel import Sharder  # noqa: E402

from test_e2e import N71, P35  # noqa: E402

torch.set_num_threads(1)

P36 = N71 // P35
# the two runs of every job: (B2, prime_chunk)
FULL = dict(b2=10000, prime_chunk=None)
CHUNKED = dict(b2=300, prime_chunk=100)
JOB = dict(n=N71, curves=8, b1=300, sigma=110)


def _files(d):
    out = {}
    for name in ("save_b1.txt", "checkpoint.txt", "ecm_results.txt"):
        path = os.path.join(d, name)
        out[name] = open(path, "rb").read() if os.path.exists(path) else b""
    return out


def _summary(res, d):
    """What a sharded run must keep: its factor list in report order,
    residues, curves_run, counters and its three files' bytes."""
    return dict(
        factors=[(h.factor, h.stage, h.curve, h.sigma) for h in res.factors],
        residues=list(res.stage1_residues), curves_run=res.curves_run,
        counters=dict(res.counters), files=_files(d))


def _paths(d):
    os.makedirs(d)
    return dict(save_b1_path=os.path.join(d, "save_b1.txt"),
                checkpoint_path=os.path.join(d, "checkpoint.txt"),
                results_path=os.path.join(d, "ecm_results.txt"))


def jax_run(root, tag, k, **kw):
    """tpu_ecm's run of kw, sharded over k virtual CPU devices (None: one
    device, no sharder)."""
    d = os.path.join(str(root), "jax_" + tag)
    kw.setdefault("stop_on_factor", False)
    sharder = JSharder(jax.devices()[:k]) if k else None
    res = j_driver.ECMDriver(j_driver.RunConfig(
        verbose=0, cache_dir=os.path.join(str(root), "cache"),
        sharder=sharder, **_paths(d), **kw)).run()
    return _summary(res, d)


def port_run(root, tag, k, **kw):
    """The port's run of kw on the CPU, sharded over k CPU devices (None:
    one device, no sharder)."""
    d = os.path.join(str(root), "port_" + tag)
    kw.setdefault("stop_on_factor", False)
    sharder = Sharder(["cpu"] * k) if k else None
    res = driver.ECMDriver(driver.RunConfig(
        verbose=0, device="cpu", sharder=sharder, **_paths(d), **kw)).run()
    return _summary(res, d)


def assert_same(got, want):
    for key in want:
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def jax_digit(tmp_path_factory):
    """tpu_ecm's digit-engine runs, once: k = 2, 3 times FULL, CHUNKED."""
    root = tmp_path_factory.mktemp("jax_digit")
    return {(k, name): jax_run(root, f"{k}_{name}", k, engine="digit",
                               **JOB, **run)
            for k in (2, 3)
            for name, run in (("full", FULL), ("chunked", CHUNKED))}


# -- the Sharder --------------------------------------------------------

def test_sharder_split_round_and_put():
    """split is NamedSharding's block layout of the last axis; round_batch
    rounds up to the device count; device_put gives each device its
    contiguous columns."""
    sh = Sharder(["cpu"] * 3)
    assert sh.n == 3 and sh.devices == [torch.device("cpu")] * 3
    assert sh.split(9) == [(0, 3), (3, 6), (6, 9)]
    assert sh.split(8) == [(0, 2), (2, 5), (5, 8)]
    assert [sh.round_batch(b) for b in (1, 3, 8, 9)] == [3, 3, 9, 9]
    x = torch.arange(2 * 4 * 6, dtype=torch.int32).reshape(2, 4, 6).numpy()
    parts = sh.device_put(x)
    assert [tuple(p.shape) for p in parts] == [(2, 4, 2)] * 3
    assert all(p.is_contiguous() and p.device.type == "cpu" for p in parts)
    assert torch.equal(torch.cat(parts, dim=-1), torch.from_numpy(x))


def test_sharder_refusals():
    """A batch that does not divide raises, as the reference asserts; so do
    a device list that mixes types, an empty one, CUDA devices on a host
    without them, and the default (every CUDA device) there."""
    with pytest.raises(ValueError, match="not divisible"):
        Sharder(["cpu"] * 3).device_put(torch.zeros(2, 8).numpy())
    with pytest.raises(ValueError, match="mix types"):
        Sharder(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one"):
        Sharder([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Sharder(["cuda:0", "cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Sharder()
    else:
        with pytest.raises(ValueError, match="not present"):
            Sharder([f"cuda:{torch.cuda.device_count()}"])


def test_wrapper_refuses_tensors_on_two_devices():
    """A kernel wrapper checks every tensor against its context's device:
    a tensor elsewhere raises before any launch (on the card: two CUDA
    devices, tests/test_torch_gpu.py)."""
    from tpu_ecm_torch import params
    from tpu_ecm_torch.limbs import torch_ops
    ctx = params.make_monty(N71)
    d = torch_ops.device_ctx(ctx, "cpu")
    nw = ctx.p.nw
    pt = torch.zeros((2, nw, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="is on meta"):
        kernels.chain(pt, pt, pt.to("meta"), 1, d)


def test_merged_finds_keep_one_runners_order():
    """Stage-2 inversion finds of two shards merge in the order one runner
    over the batch meets them: shard 1's curve 0 (global 4), found at the
    first inversion, before shard 0's curves 1 and 3, found at the second,
    and shard 1's curve 2 (global 6) at the third."""
    from tpu_ecm_torch.stage2.exec import Stage2Result

    def res(factors, found_at):
        return Stage2Result(acc=[], factors=factors, paired=0, slots=0,
                            ptadds=0, ptdups=0, numinv=3, found_at=found_at)

    shard0 = res({3: 11, 1: 13}, {3: 2, 1: 2})
    shard1 = res({2: 17, 0: 19}, {2: 3, 0: 1})
    assert driver.merged_finds([shard0, shard1], [0, 4]) == [
        (4, 19), (1, 13), (3, 11), (6, 17)]


def test_pa_group_rule_shares_a_card(monkeypatch):
    """The card's memory rule of a shard (stage2/exec.pa_group_for_ops)
    takes its share of the free bytes: two shards on one card (mem_share
    1/2, set by the driver) each get the group of half the bytes, with
    noinv's three planes a row counted."""
    from types import SimpleNamespace
    from tpu_ecm_torch.stage2 import exec as s2exec
    free = 12 * 10**9
    monkeypatch.setattr(s2exec, "device_free_bytes", lambda device: free)
    sp = SimpleNamespace(num_pb=963)
    plane = 36 * 2048 * 4

    def group(share, cross="inv"):
        ops = SimpleNamespace(rows=36, device="cuda:0", mem_share=share)
        return s2exec.pa_group_for_ops(ops, sp, 2048, cross)

    assert group(1.0) == 4096
    assert group(0.5) == 2048 == s2exec.pa_group_for_memory(
        plane, 963, free // 2)
    assert group(0.5, "noinv") == 512 == s2exec.pa_group_for_memory(
        plane, 963, free // 2, planes=3)
    drv = driver.ECMDriver(driver.RunConfig(
        n=N71, curves=4, b1=300, device="cpu", verbose=0,
        sharder=Sharder(["cpu"] * 2)))
    assert [ops.mem_share for ops in drv.shard_ops] == [0.5, 0.5]


# -- the digit engine against tpu_ecm's Sharder ---------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_digit_sharded_equals_tpu_ecm_sharded(tmp_path, jax_digit, k):
    """The port over k devices (k = 1: the sharded path on one device)
    equals tpu_ecm sharded over max(k, 2) devices (curves rounded to
    whole shards at k = 3 on both sides), in both runs of the job."""
    for name, run in (("full", FULL), ("chunked", CHUNKED)):
        got = port_run(tmp_path, f"{k}_{name}", k, engine="digit", **JOB,
                       **run)
        want = jax_digit[(max(k, 2), name)]
        if k == 1:
            assert got["curves_run"] == 8
            got = dict(got, curves_run=want["curves_run"])
        assert_same(got, want)
        if name == "full":
            assert (P35, 2, 2, 112) in got["factors"]


def test_digit_full_run_finds_and_files(jax_digit):
    """The pinned content of the reference runs the port is held to: P35
    at sigma 112 and P36 at sigma 111 in stage 2, 9 curves and 9 records
    at k = 3, two checkpoints of 8 records at k = 2."""
    full3 = jax_digit[(3, "full")]
    assert {(f, st, s) for f, st, _c, s in full3["factors"]} == {
        (P35, 2, 112), (P36, 2, 111)}
    assert full3["curves_run"] == 9
    assert full3["files"]["save_b1.txt"].count(b"SIGMA=") == 9
    ck = jax_digit[(2, "chunked")]["files"]["checkpoint.txt"]
    assert ck.count(b"SIGMA=") == 16


def test_stop_on_factor_with_batches(tmp_path):
    """Batches round to whole shards like the total (batch=3 at k = 2 runs
    batches of 4): the sharded run stops after the batch of the sigma-174
    stage-1 find, as the one-device run with batch=4 does."""
    job = dict(JOB, sigma=172, b2=300, stop_on_factor=True)
    one = port_run(tmp_path, "b1", None, engine="digit", batch=4, **job)
    two = port_run(tmp_path, "b2", 2, engine="digit", batch=3, **job)
    assert_same(two, one)
    assert two["curves_run"] == 4 and two["factors"]
