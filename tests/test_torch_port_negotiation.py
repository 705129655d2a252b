"""The port's negotiated engine against the JAX package's, in one
process: the signature strings byte for byte, the Python core's and the
C++ core's batch lists for the same submissions, the wire between a
reference core and a port core in both roles, the Adasum batch rule
(also fed to the controller's executor as a constructed batch), the
dispatch thread's own world set, a duplicate pending name, ``join`` in
a world of one, the refused control tree, the job secret, and the
loader's rules (build into ``_build/core``, never a stale library, no
fallback).

Every core here runs in this process on 127.0.0.1; the multi-process
worlds are tests/test_torch_port_negotiation_mp.py's.
"""

import os
import shutil
import socket
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from horovod_tpu_torch.core import native as tnative
from horovod_tpu_torch.ops import controller as tctl

DTYPES = [("bfloat16", torch.bfloat16), ("float16", torch.float16),
          ("float32", torch.float32), ("int32", torch.int32)]


@pytest.fixture(scope="module")
def port_lib():
    """The port's core, built once into its _build directory."""
    return tnative.load()


def _ref_native():
    from horovod_tpu.core import native as jnative
    if not jnative.available():
        pytest.fail("the reference's native core did not build")
    return jnative


# ---------------------------------------------------------------------------
# Signatures

@pytest.mark.parametrize("raws", [["bfloat16"], ["float16"], ["float32"],
                                  ["int32"], ["float32", "bfloat16",
                                              "float16"]])
@pytest.mark.parametrize("wire", ["same", "float16", "bfloat16"])
def test_allreduce_sig_is_the_references(raws, wire):
    import jax.numpy as jnp
    from horovod_tpu.ops import controller as jctl
    shapes = [(4096, 11008), (7,), ()][:len(raws)]
    wire_name = raws[0] if wire == "same" else wire
    want = jctl.allreduce_sig(jnp.dtype(wire_name),
                              [jnp.dtype(r) for r in raws], shapes, 2, 3,
                              0.5, 1.0)
    got = tctl.allreduce_sig(getattr(torch, wire_name),
                             [getattr(torch, r) for r in raws],
                             [torch.Size(s) for s in shapes], 2, 3, 0.5,
                             1.0)
    assert got == want
    assert tctl.parse_allreduce_sig(got) == jctl.parse_allreduce_sig(want)


class _RecordingCore:
    """Records what a controller submits; agrees nothing."""

    def __init__(self):
        self.submitted = []
        self._stop = threading.Event()

    def submit(self, name, sig, nbytes, meta=""):
        self.submitted.append((name, sig, nbytes, meta))

    def next_batch(self, timeout_s):
        return None if self._stop.wait(timeout_s) else []

    def all_joined(self):
        return -1

    def set_quiescence(self, n):
        pass

    def shutdown(self):
        self._stop.set()

    def destroy(self):
        pass


def _controllers():
    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu.ops.controller import NegotiatedController as JCtl
    from horovod_tpu.ops.engine import Engine as JEngine
    from horovod_tpu_torch.common.config import Config as TConfig
    from horovod_tpu_torch.ops.engine import Engine as TEngine
    topo = types.SimpleNamespace(rank=0, size=1)
    jcfg, tcfg = JConfig(), TConfig()
    jcore, tcore = _RecordingCore(), _RecordingCore()
    j = JCtl(jcfg, topo, JEngine(jcfg, topo, None), core=jcore)
    t = tctl.NegotiatedController(tcfg, topo, TEngine(tcfg, topo, None),
                                  core=tcore)
    return (j, jcore), (t, tcore)


@pytest.mark.parametrize("name,dt", DTYPES + [("bool", torch.bool)])
def test_bc_ag_rs_keys_are_the_references(name, dt):
    import jax.numpy as jnp
    from horovod_tpu.ops.compression import NoneCompressor
    from horovod_tpu_torch.ops.compression import Compression
    (j, jcore), (t, tcore) = _controllers()
    pset = types.SimpleNamespace(process_set_id=0, ranks=[0], size=1)
    try:
        for shape in [(3, 5), (4,), ()]:
            x = np.ones(shape, dtype=np.float32)
            jx = jnp.asarray(x).astype(name)
            tx = torch.from_numpy(x).to(dt)
            tag = f"{name}{len(shape)}"
            j.submit_broadcast(f"bc{tag}", jx, 0, pset)
            t.submit_broadcast(f"bc{tag}", tx, 0, pset)
            j.submit_allgather(f"ag{tag}", jx, pset)
            t.submit_allgather(f"ag{tag}", tx, pset)
            j.submit_reducescatter(f"rs{tag}", jx, pset, 1, 1.0, 0.25)
            t.submit_reducescatter(f"rs{tag}", tx, pset, 1, 1.0, 0.25)
        j.submit_allreduce("ar", [jnp.ones((2, 3), name)], pset, 1, 1.0,
                           1.0, NoneCompressor)
        t.submit_allreduce("ar", [torch.ones((2, 3), dtype=dt)], pset, 1,
                           1.0, 1.0, Compression.none)
        assert tcore.submitted == jcore.submitted
    finally:
        j.shutdown()
        t.shutdown()


# ---------------------------------------------------------------------------
# Batch lists: the Python core and the C++ core (size 1)

def _drain(core, want, timeout=10.0):
    batches, got = [], 0
    deadline = time.monotonic() + timeout
    while got < want and time.monotonic() < deadline:
        b = core.next_batch(0.2)
        assert b is not None
        if b:
            batches.append([(e.name, e.sig, e.meta) for e in b])
            got += len(b)
    return batches


CASES = {
    # 3 x 48 bytes under a 64-byte threshold: one entry per batch.
    "threshold_split": dict(threshold=64, quiesce=5, subs=[
        (f"s{i}", "ar|float32|1|0|1.0|1.0#float32:12", 48)
        for i in range(3)]),
    # a key change ends a batch.
    "key_change": dict(threshold=1 << 20, quiesce=5, subs=[
        ("a", "ar|float32|1|0|1.0|1.0#float32:4", 16),
        ("b", "ar|float64|1|0|1.0|1.0#float64:4", 32),
        ("c", "ar|float32|1|0|1.0|1.0#float32:4", 16)]),
    # a trickling storm cuts as one batch under quiescence (50 quiet
    # 1 ms cycles against 2 ms gaps: margin for a loaded host).
    "quiescence_storm": dict(threshold=1 << 20, quiesce=50, gap=0.002, subs=[
        (f"q{i}", "ar|float32|1|0|1.0|1.0#float32:8", 32)
        for i in range(8)]),
}


def _run_case(core, case):
    core.set_quiescence(case["quiesce"])

    def storm():
        for name, sig, nbytes in case["subs"]:
            core.submit(name, sig, nbytes)
            if case.get("gap"):
                time.sleep(case["gap"])
    th = threading.Thread(target=storm)
    th.start()
    try:
        return _drain(core, len(case["subs"]))
    finally:
        th.join()
        core.shutdown()
        core.destroy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_core_batches_are_the_references(case):
    from horovod_tpu.ops.controller import PythonCore as JCore
    c = CASES[case]
    want = _run_case(JCore(c["threshold"], 1.0), c)
    got = _run_case(tctl.PythonCore(c["threshold"], 1.0), c)
    assert got == want
    assert sum(len(b) for b in got) == len(c["subs"])


def _native_core(mod, **kw):
    args = dict(rank=0, size=1, coord_host="127.0.0.1", coord_port=0,
                fusion_threshold=1 << 20, cycle_time_ms=1.0,
                stall_warn_s=0.0, stall_kill_s=0.0)
    args.update(kw)
    return mod.NativeCore(**args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_core_batches_are_the_references(case, port_lib):
    c = CASES[case]
    jnative = _ref_native()
    want = _run_case(_native_core(jnative, fusion_threshold=c["threshold"]),
                     c)
    got = _run_case(_native_core(tnative, fusion_threshold=c["threshold"]),
                    c)
    assert got == want
    if case == "quiescence_storm":
        assert len(got) == 1
    if case == "threshold_split":
        assert [len(b) for b in got] == [1, 1, 1]


# ---------------------------------------------------------------------------
# The wire: a reference core and a port core negotiating together

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("coordinator", ["reference", "port"])
def test_reference_and_port_cores_agree_on_the_wire(coordinator, port_lib):
    """Six names submitted in different orders (four allreduces, two
    allgathers whose per-rank first dims ride the metadata): both
    ranks receive the same (name, sig, metas) batches."""
    mods = {"reference": _ref_native(), "port": tnative}
    other = "port" if coordinator == "reference" else "reference"
    port = _free_port()
    kw = dict(size=2, coord_port=port, cycle_time_ms=1.0,
              connect_timeout_s=20.0)
    c0 = _native_core(mods[coordinator], rank=0, **kw)
    c1 = _native_core(mods[other], rank=1, **kw)
    subs = [(f"ar{i}", f"ar|float32|1|0|1.0|1.0#float32:{4 + i}",
             4 * (4 + i), "") for i in range(4)]
    subs += [(f"ag{i}", "ag|bfloat16|0#3", 6, None) for i in range(2)]
    try:
        for rank, core, order in ((0, c0, subs), (1, c1, subs[::-1])):
            for name, sig, nbytes, meta in order:
                core.submit(name, sig, nbytes,
                            str(rank + 2) if meta is None else meta)
        b0, b1 = _drain(c0, 6), _drain(c1, 6)
    finally:
        for c in (c1, c0):
            c.shutdown()
            c.destroy()
    assert b0 == b1
    flat = [e for b in b0 for e in b]
    assert sorted(n for n, _, _ in flat) == sorted(s[0] for s in subs)
    assert {m for n, _, m in flat if n.startswith("ag")} == {"2;3"}


# ---------------------------------------------------------------------------
# Adasum: one vector per entry of a batch

def test_adasum_batch_is_one_vector_per_entry(monkeypatch):
    """Two entries agreed in one Adasum batch fold each as its own
    vector (declared difference; the reference's controller folds the
    batch's concatenation). Two simulated ranks, each running the
    controller's executor on its own thread over a shared gather."""
    from horovod_tpu_torch.ops import adasum as tadasum
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops.compression import Compression
    rows = {r: [torch.from_numpy(np.random.RandomState(10 * r + k)
                                 .randn(n).astype(np.float32))
                for k, n in enumerate((37, 11))] for r in range(2)}
    barrier = threading.Barrier(2)
    box = {}

    def fake_gather(flat, pset):
        box[pset.rank()] = flat
        barrier.wait()
        return [box[0], box[1]]

    monkeypatch.setattr(tadasum, "_adasum_mode", "gather")
    monkeypatch.setattr(tadasum, "gather_rows", fake_gather)
    outs = {}

    def run(r):
        pset = types.SimpleNamespace(size=2, rank=lambda: r)
        outs[r] = []
        for entry in ([rows[r][0]], [rows[r][1]]):
            outs[r] += C._adasum_group(entry, pset, 1.0, 1.0,
                                       [Compression.none])
            barrier.wait()
    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    for k in range(2):
        want = tadasum.adasum_reference([rows[0][k].numpy(),
                                         rows[1][k].numpy()])
        np.testing.assert_allclose(outs[0][k].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(outs[0][k], outs[1][k])
    joint = tadasum.adasum_reference([np.concatenate([x.numpy() for x in
                                                      rows[r]])
                                      for r in range(2)])
    assert np.abs(joint[:37] - outs[0][0].numpy()).max() > 1e-3


# ---------------------------------------------------------------------------
# The engine in a world of one

@pytest.fixture
def world_of_one():
    import horovod_tpu_torch as hvd

    def start(**overrides):
        hvd.init(config_overrides=overrides)
        from horovod_tpu_torch.common.basics import state
        return hvd, state().engine.controller
    yield start
    hvd.shutdown()


class _HoldingCore(tctl.PythonCore):
    """A Python core that agrees nothing until released."""

    def __init__(self):
        super().__init__(1 << 20)
        self.release = threading.Event()

    def next_batch(self, timeout_s):
        if not self.release.wait(timeout_s):
            return None if self._shutdown else []
        return super().next_batch(timeout_s)


def test_duplicate_pending_name_errors_its_handle():
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.ops.engine import Engine
    cfg, topo = Config(), types.SimpleNamespace(rank=0, size=1)
    core = _HoldingCore()
    pset = types.SimpleNamespace(process_set_id=0, ranks=[0], size=1)
    eng = Engine(cfg, topo, types.SimpleNamespace(get=lambda i: pset))
    ctl = tctl.NegotiatedController(cfg, topo, eng, core=core)
    try:
        h1 = ctl.submit_allreduce("dup", [torch.ones(2)], pset, 1, 1.0, 1.0,
                                  Compression.none)
        h2 = ctl.submit_allreduce("dup", [torch.ones(2)], pset, 1, 1.0, 1.0,
                                  Compression.none)
        with pytest.raises(ValueError, match="already pending"):
            h2.wait()
        core.release.set()
        assert torch.equal(eng.synchronize(h1), torch.ones(2))
    finally:
        ctl.shutdown()


def _held_controller(world=None):
    """A controller in a world of one over a core that agrees nothing
    itself: the tests feed its executors constructed batches."""
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.ops.engine import Engine
    cfg, topo = Config(), types.SimpleNamespace(rank=0, size=1)
    pset = types.SimpleNamespace(process_set_id=0, ranks=[0], size=1)
    eng = Engine(cfg, topo, types.SimpleNamespace(get=lambda i: pset))
    core = _HoldingCore()
    return tctl.NegotiatedController(cfg, topo, eng, core=core,
                                     world=world), pset, core


def test_an_adasum_batch_runs_one_vector_per_entry(monkeypatch):
    """The executor itself, fed one agreed Adasum batch of two entries
    (a tensor alone, then a grouped pair): one Adasum group per entry,
    whatever the coordinator fused."""
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops.compression import Compression
    calls = []

    def fake_adasum(tensors, pset, pre, post, comps):
        calls.append([tuple(t.shape) for t in tensors])
        return [t * 2 for t in tensors]
    monkeypatch.setattr(C, "_adasum_group", fake_adasum)
    ctl, pset, core = _held_controller()
    try:
        a, b = [torch.ones(3)], [torch.ones(2, 2), torch.ones(5)]
        ha = ctl.submit_allreduce("a", a, pset, C.ADASUM, 1.0, 1.0,
                                  Compression.none)
        hb = ctl.submit_allreduce("b", b, pset, C.ADASUM, 1.0, 1.0,
                                  Compression.none, grouped=True)
        sig = lambda ts: tctl.allreduce_sig(  # noqa: E731
            torch.float32, [t.dtype for t in ts], [t.shape for t in ts],
            C.ADASUM, 0, 1.0, 1.0)
        ctl._execute_allreduce_batch([
            tnative.BatchEntry("a", sig(a), 1, ""),
            tnative.BatchEntry("b", sig(b), 1, "")])
        assert calls == [[(3,)], [(2, 2), (5,)]]
        assert torch.equal(ha.wait(), torch.full((3,), 2.0))
        assert [x.tolist() for x in hb.wait()] == [[[2.0, 2.0]] * 2,
                                                   [2.0] * 5]
    finally:
        core.release.set()
        ctl.shutdown()


def test_the_dispatch_thread_runs_over_its_own_world_set(monkeypatch):
    """Agreed allreduces and generic ops on the world set run over the
    controller's twin of it (its own groups), not the set the caller
    submitted with."""
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops.compression import Compression
    seen = []

    def fake_reduce(tensors, pset, *args, **kw):
        seen.append(pset)
        return list(tensors)
    monkeypatch.setattr(C, "_reduce_group", fake_reduce)
    world = types.SimpleNamespace(process_set_id=0, ranks=[0], size=1)
    ctl, pset, core = _held_controller(world)
    try:
        h1 = ctl.submit_allreduce("ar", [torch.ones(2)], pset, C.SUM, 1.0,
                                  1.0, Compression.none)
        h2 = ctl.submit_generic("g", 0, lambda ps: ps, pset)
        core.release.set()
        assert torch.equal(h1.wait(), torch.ones(2))
        assert h2.wait() is world
        assert seen == [world]
    finally:
        ctl.shutdown()


def test_zero_fill_goes_on_the_batchs_device_else_the_ranks(monkeypatch):
    """A joined rank's zeros (entries it never submitted) take the raw
    dtypes and shapes of the agreed signature, on the device of the
    batch's live tensors, else on the rank's device (declared
    difference: the reference makes them on the host)."""
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.ops.engine import Engine
    seen = []

    def fake_reduce(tensors, *args, **kw):
        seen.append([(t.device.type, t.dtype, tuple(t.shape))
                     for t in tensors])
        return list(tensors)
    monkeypatch.setattr(C, "_reduce_group", fake_reduce)
    cfg, topo = Config(), types.SimpleNamespace(rank=0, size=1)
    pset = types.SimpleNamespace(process_set_id=0, ranks=[0], size=1)
    eng = Engine(cfg, topo, types.SimpleNamespace(get=lambda i: pset))
    ctl = tctl.NegotiatedController(cfg, topo, eng, core=_HoldingCore(),
                                    device=torch.device("meta"))
    try:
        ghost = tctl.allreduce_sig(torch.float16,
                                   [torch.float32, torch.bfloat16],
                                   [(3, 2), (5,)], 1, 0, 1.0, 1.0)
        ctl._execute_allreduce_batch([tnative.BatchEntry("ghost", ghost, 1,
                                                         "")])
        assert seen[-1] == [("meta", torch.float32, (3, 2)),
                            ("meta", torch.bfloat16, (5,))]
        h = ctl.submit_allreduce("live", [torch.ones(4)], pset, 1, 1.0, 1.0,
                                 Compression.fp16)
        live = tctl.allreduce_sig(torch.float16, [torch.float32], [(4,)], 1,
                                  0, 1.0, 1.0)
        ctl._execute_allreduce_batch([
            tnative.BatchEntry("live", live, 1, ""),
            tnative.BatchEntry("ghost", ghost, 1, "")])
        assert seen[-1] == [("cpu", torch.float32, (4,)),
                            ("cpu", torch.float32, (3, 2)),
                            ("cpu", torch.bfloat16, (5,))]
        assert torch.equal(h.wait(), torch.ones(4))
    finally:
        ctl.shutdown()


@pytest.mark.parametrize("mode", ["python", "native"])
def test_join_in_a_world_of_one(world_of_one, mode, port_lib):
    hvd, ctl = world_of_one(HOROVOD_CONTROLLER=mode)
    assert type(ctl.core).__name__ == {"python": "PythonCore",
                                       "native": "NativeCore"}[mode]
    x = torch.arange(6.0)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    assert hvd.join() == 0


def test_many_submitting_threads_lose_no_op(world_of_one, port_lib):
    """Twice as many submitting threads as cores against the dispatch
    thread, with a short switch interval: every op completes with its
    own answer and the executed entries add up."""
    hvd, ctl = world_of_one(HOROVOD_CONTROLLER="native")
    n_threads, per = 2 * (os.cpu_count() or 4), 40
    errors = []

    def submit(t):
        try:
            hs = [(hvd.allreduce_async(torch.full((3,), float(t * per + i)),
                                       name=f"s{t}.{i}", op=hvd.Sum),
                   t * per + i) for i in range(per)]
            for h, v in hs:
                assert torch.equal(hvd.synchronize(h),
                                   torch.full((3,), float(v)))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert ctl.exec_counts["ar"][1] == n_threads * per


def test_the_control_tree_is_refused(world_of_one):
    """HOROVOD_CONTROL_TREE_ARITY >= 2 raises at init: the port has no
    hierarchical control tree, and nothing falls back to the star."""
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        world_of_one(HOROVOD_CONTROLLER="native",
                     HOROVOD_CONTROL_TREE_ARITY=2)
    from horovod_tpu_torch.common.basics import is_initialized
    assert not is_initialized()


def test_the_control_plane_secret_is_the_job_secret(monkeypatch):
    monkeypatch.setenv("HOROVOD_SECRET", "s3cr3t")
    assert tctl.control_plane_secret() == "s3cr3t"
    monkeypatch.delenv("HOROVOD_SECRET")
    assert tctl.control_plane_secret() == ""


def test_join_without_the_controller_raises(world_of_one):
    hvd, ctl = world_of_one()
    assert ctl is None
    with pytest.raises(NotImplementedError, match="controller"):
        hvd.join()


# ---------------------------------------------------------------------------
# The loader

def test_the_core_builds_into_the_build_directory(port_lib):
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.endswith(os.path.join("horovod_tpu_torch",
                                                   "_build", "core"))
    with open(path + ".srchash") as f:
        assert f.read() == tnative.source_hash(tnative.CC_DIR)
    built = [n for n in os.listdir(tnative.CC_DIR)
             if n.endswith((".so", ".srchash", ".lock"))]
    assert built == []


def test_a_broken_source_raises_and_the_stale_library_is_not_loaded(
        tmp_path, port_lib):
    cc, out = tmp_path / "cc", tmp_path / "build"
    shutil.copytree(tnative.CC_DIR, cc)
    out.mkdir()
    lib = str(out / tnative.LIB_NAME)
    shutil.copy(tnative.build(), lib)          # built from these sources
    with open(lib + ".srchash", "w") as f:
        f.write(tnative.source_hash(str(cc)))
    with open(cc / "controller.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="build of .* failed") as err:
        tnative.load(str(cc), str(out))
    assert "controller.cc" in str(err.value)      # the compiler's output
    assert os.path.exists(lib)                    # stale, and not loaded
    assert lib not in tnative._libs


def test_no_toolchain_raises(tmp_path, monkeypatch):
    cc = tmp_path / "cc"
    shutil.copytree(tnative.CC_DIR, cc)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="not found"):
        tnative.build(str(cc), str(tmp_path / "build"))
