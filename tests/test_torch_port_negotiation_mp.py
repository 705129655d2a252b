"""The negotiated engine in spawned gloo worlds of 2 and 3 CPU ranks,
each checked against answers computed on the host: the cases of
tests/mp_worker_negotiation.py (out-of-order submission, fusion of many
small tensors, a mixed-dtype group, fused broadcast, uneven allgather
and reducescatter, a shape mismatch that errors every rank and leaves
the next op working, ``join`` with a join-aware Average and a broadcast
the coordinator refuses) plus ``check_execution_order``, two
DistributedOptimizer steps negotiated and inline from the same start
(bitwise equal at 2 ranks), the bucketed train step staying off the
engine, the same steps again while negotiated ops run on the dispatch
thread (its world groups are its own, so the two threads' collectives
never pair), the same out-of-order submission inline giving a wrong
answer, a core
that does not build failing init on every rank, and an adopted group
whose ranks report different hosts needing HOROVOD_CONTROL_ADDR.

Hygiene as tests/test_torch_port_distributed.py's ``spawn_world``:
``file://`` stores in ``tmp_path``, 60 s group and join timeouts,
stragglers killed, children that load no JAX. Every world adopts its
group with no HOROVOD_COORDINATOR_ADDR, so the controller finds rank
0's control port through the adopted group. The core is built once,
here, before any child spawns; the worlds run side by side.
"""

import shutil
import socket
import threading

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.core import native
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import train as ttrain

from test_torch_port_distributed import spawn_world

N_OOO = 6
OVERRIDES = {"HOROVOD_ORDER_CHECK": True}


def _ooo_value(i, rank, n=8):
    return torch.full((n,), float(100 * i + rank + 1))


def _ooo(rank, n, prefix):
    """Each rank submits the same six names (distinct values, one
    shape); rank 1 in reverse order. name -> result."""
    names = [f"{prefix}{i}" for i in range(N_OOO)]
    order = names[::-1] if rank == 1 else names
    hs = {nm: hvd.allreduce_async(_ooo_value(names.index(nm), rank, n),
                                  name=nm, op=hvd.Sum) for nm in order}
    return {nm: hvd.synchronize(hs[nm]).tolist() for nm in names}


def _dopt_steps(rank):
    """Two DistributedOptimizer(AdamW, Average) steps from seed 0,
    each rank on its own batch; parameters after each step."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters())
    out = []
    for step in range(2):
        g = torch.Generator().manual_seed(100 * step + rank)
        x = torch.randn(5, 6, generator=g)
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
        out.append([p.detach().numpy().copy() for p in model.parameters()])
    return out


def _bucketed_steps(rank, steps=2):
    """Bucketed train steps (overlap on) from seed 1, each rank on its
    own batches: the losses and the parameters after the last."""
    torch.manual_seed(1)
    model = torch.nn.Linear(4, 3)
    step = ttrain.build_train_step(
        lambda m, bt: (m(bt["x"]) - bt["y"]).square().mean(),
        torch.optim.SGD(model.parameters(), lr=0.1), "cpu",
        mesh=tmesh.data_parallel_mesh(), overlap=True)
    g = torch.Generator().manual_seed(rank)
    losses = [float(step(model, {"x": torch.randn(3, 4, generator=g),
                                 "y": torch.randn(3, 3, generator=g)})
                    ["loss"]) for _ in range(steps)]
    return losses, [p.detach().numpy().copy() for p in model.parameters()]


def _side_traffic(rank, box):
    """Negotiated ops for the dispatch thread: eight allreduces in
    flight together, then an object gather."""
    hs = [hvd.allreduce_async(torch.full((256,), float(i + rank)),
                              name=f"side{i}", op=hvd.Sum)
          for i in range(8)]
    box["ar"] = [hvd.synchronize(h).tolist() for h in hs]
    box["obj"] = hvd.allgather_object(("side", rank))


def _exec(ctl, kind):
    return list(ctl.exec_counts.get(kind, [0, 0]))


def _delta(ctl, kind, before):
    now = _exec(ctl, kind)
    return now[0] - before[0], now[1] - before[1]


def job_negotiation(rank, size, args):
    ctl = basics.state().engine.controller
    out = {"core": type(ctl.core).__name__, "ooo": _ooo(rank, 8, "ooo_")}

    # Fusion: hold cuts until the ready set is stable for 20 cycles (the
    # reference's worker holds 3), so a loaded host still fuses.
    ctl.core.set_quiescence(20)
    b = _exec(ctl, "ar")
    hs = [hvd.allreduce_async(torch.full((8,), float(i + rank)),
                              name=f"f{i}", op=hvd.Sum) for i in range(16)]
    out["fused"] = [hvd.synchronize(h).tolist() for h in hs]
    out["fused_counts"] = _delta(ctl, "ar", b)

    group = [torch.arange(6, dtype=torch.float32) + rank,
             (torch.arange(4) + rank).to(torch.bfloat16),
             torch.full((3,), float(rank), dtype=torch.float64),
             torch.tensor([rank, 2], dtype=torch.int32)]
    out["mixed"] = [(str(t.dtype), t.double().tolist())
                    for t in hvd.grouped_allreduce(group, op=hvd.Sum)]

    b = _exec(ctl, "bc")
    hs = [hvd.broadcast_async(torch.full((4,), float(i) if rank == 0
                                         else -1.0), root_rank=0,
                              name=f"bc{i}") for i in range(8)]
    out["bc"] = [hvd.synchronize(h).tolist() for h in hs]
    out["bc_counts"] = _delta(ctl, "bc", b)
    b = _exec(ctl, "ag")
    hs = [hvd.allgather_async(torch.full((rank + 1, 2), float(10 * i + rank)),
                              name=f"ag{i}") for i in range(6)]
    out["ag"] = [hvd.synchronize(h).tolist() for h in hs]
    out["ag_counts"] = _delta(ctl, "ag", b)
    b = _exec(ctl, "rs")
    d0s = [size * 2, size * 2 + 1, size * 3, size * 2 + 3]
    vals = [torch.arange(d * 2, dtype=torch.float32).reshape(d, 2)
            + float(rank + i) for i, d in enumerate(d0s)]
    hs = [hvd.reducescatter_async(v, op=hvd.Sum, name=f"rs{i}")
          for i, v in enumerate(vals)]
    out["rs"] = [hvd.synchronize(h).tolist() for h in hs]
    out["rs_counts"] = _delta(ctl, "rs", b)
    ctl.core.set_quiescence(0)

    try:
        hvd.allreduce(torch.ones(2 + rank), name="mismatch", op=hvd.Sum)
        out["mismatch"] = "no error"
    except RuntimeError as e:
        out["mismatch"] = str(e)
    out["after_mismatch"] = hvd.allreduce(torch.ones(3), name="after",
                                          op=hvd.Sum).tolist()
    out["order_count"] = hvd.check_execution_order()
    out["dopt_negotiated"] = _dopt_steps(rank)

    # The bucketed train step: its exchange and its loss mean stay off
    # the engine.
    before = {k: list(v) for k, v in ctl.exec_counts.items()}
    out["train_losses"], out["train_params"] = _bucketed_steps(rank)
    out["train_exec_unchanged"] = before == ctl.exec_counts
    # The same steps while the dispatch thread runs negotiated ops over
    # its own world groups.
    out["twin_group"] = ctl._world is not None and \
        ctl._world.group is not None
    side = {}
    t = threading.Thread(target=_side_traffic, args=(rank, side))
    t.start()
    out["side_losses"], out["side_params"] = _bucketed_steps(rank)
    t.join(30)
    out["side"] = side

    # join: every rank but 0 joins at once; rank 0 reduces alone.
    if rank == 0:
        out["after_join"] = hvd.allreduce(torch.full((3,), 10.0),
                                          name="after_join").tolist()
        fp16 = hvd.allreduce(torch.full((5,), 6.0), name="after_join_fp16",
                             op=hvd.Sum, compression=hvd.Compression.fp16)
        out["after_join_fp16"] = (str(fp16.dtype), fp16.tolist())
        try:
            hvd.broadcast(torch.ones(2), root_rank=0, name="join_bcast")
            out["join_bcast"] = "no error"
        except RuntimeError as e:
            out["join_bcast"] = str(e)
    out["join"] = hvd.join()

    # Inline from here: the same out-of-order submission, and the same
    # optimizer steps.
    hvd.shutdown()
    hvd.init(config_overrides={"HOROVOD_CONTROLLER": "inline"})
    out["inline_controller"] = basics.state().engine.controller
    out["ooo_inline"] = _ooo(rank, 4096, "ooo_inline_")
    out["dopt_inline"] = _dopt_steps(rank)

    # A core that does not build: init raises on every rank, nothing
    # falls back, and a good core brings init back.
    if size == 2:
        hvd.shutdown()
        cc_dir, build_dir = native.CC_DIR, native.BUILD_DIR
        native.CC_DIR, native.BUILD_DIR = args["broken_cc"][rank], \
            args["broken_build"][rank]
        try:
            hvd.init()
            out["broken"] = "init passed"
        except RuntimeError as e:
            out["broken"] = str(e)
        finally:
            native.CC_DIR, native.BUILD_DIR = cc_dir, build_dir
        # Ranks that report different hosts: init raises on every rank,
        # naming the knob to set.
        real = socket.gethostname
        socket.gethostname = lambda: f"host-{rank}"
        try:
            hvd.init()
            out["two_hosts"] = "init passed"
        except RuntimeError as e:
            out["two_hosts"] = str(e)
        finally:
            socket.gethostname = real
        hvd.init()
        out["recovered"] = hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    native.load()                      # build once, before any child
    root = tmp_path_factory.mktemp("negotiation")
    broken_cc, broken_build = [], []
    for r in range(2):
        cc = root / f"broken-cc-{r}"
        shutil.copytree(native.CC_DIR, cc)
        with open(cc / "controller.cc", "a") as f:
            f.write("\nthis is not C++;\n")
        broken_cc.append(str(cc))
        broken_build.append(str(root / f"broken-build-{r}"))
    results, errors = {}, {}

    def run(size):
        try:
            results[size] = spawn_world(
                size, job_negotiation, root, timeout=60,
                overrides=OVERRIDES, broken_cc=broken_cc,
                broken_build=broken_build)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[size] = e
    threads = [threading.Thread(target=run, args=(n,)) for n in (2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return results


SIZES = [2, 3]


@pytest.mark.parametrize("size", SIZES)
def test_out_of_order_gets_each_names_answer(worlds, size):
    for out in worlds[size]:
        assert out["core"] == "NativeCore" and out["loaded"] == []
        for i in range(N_OOO):
            want = sum(100 * i + r + 1 for r in range(size))
            assert out["ooo"][f"ooo_{i}"] == [float(want)] * 8


@pytest.mark.parametrize("size", SIZES)
def test_inline_out_of_order_gives_a_wrong_answer(worlds, size):
    """The check above can fail: the same submission with the
    controller off pairs different names across ranks."""
    dist = []
    for out in worlds[size]:
        assert out["inline_controller"] is None
        for i in range(N_OOO):
            want = float(sum(100 * i + r + 1 for r in range(size)))
            dist.append(abs(out["ooo_inline"][f"ooo_inline_{i}"][0] - want))
    assert max(dist) >= 100.0, dist


@pytest.mark.parametrize("size", SIZES)
def test_small_tensors_fuse(worlds, size):
    for out in worlds[size]:
        for i, got in enumerate(out["fused"]):
            assert got == [float(sum(i + r for r in range(size)))] * 8
        batches, entries = out["fused_counts"]
        assert entries == 16 and batches < entries, out["fused_counts"]


@pytest.mark.parametrize("size", SIZES)
def test_mixed_dtype_group(worlds, size):
    want = [("torch.float32", [float(sum(k + r for r in range(size)))
                               for k in range(6)]),
            ("torch.bfloat16", [float(sum(k + r for r in range(size)))
                                for k in range(4)]),
            ("torch.float64", [float(sum(range(size)))] * 3),
            ("torch.int32", [float(sum(range(size))), 2.0 * size])]
    for out in worlds[size]:
        assert out["mixed"] == want


@pytest.mark.parametrize("size", SIZES)
def test_fused_broadcast_allgather_reducescatter(worlds, size):
    d0s = [size * 2, size * 2 + 1, size * 3, size * 2 + 3]
    for rank, out in enumerate(worlds[size]):
        assert out["bc"] == [[float(i)] * 4 for i in range(8)]
        for i, got in enumerate(out["ag"]):
            want = np.concatenate([np.full((r + 1, 2), 10.0 * i + r)
                                   for r in range(size)])
            np.testing.assert_array_equal(np.asarray(got), want)
        for i, got in enumerate(out["rs"]):
            full = sum(np.arange(d0s[i] * 2, dtype=np.float32)
                       .reshape(d0s[i], 2) + float(r + i)
                       for r in range(size))
            base, rem = divmod(d0s[i], size)
            rows = [base + (1 if j < rem else 0) for j in range(size)]
            off = sum(rows[:rank])
            np.testing.assert_array_equal(np.asarray(got),
                                          full[off:off + rows[rank]])
        for kind, n in (("bc", 8), ("ag", 6), ("rs", 4)):
            batches, entries = out[f"{kind}_counts"]
            assert entries == n and batches < entries, (kind, batches)


@pytest.mark.parametrize("size", SIZES)
def test_shape_mismatch_errors_every_rank_and_the_next_op_works(worlds,
                                                                size):
    for out in worlds[size]:
        assert "mismatch" in out["mismatch"].lower(), out["mismatch"]
        assert out["after_mismatch"] == [float(size)] * 3


@pytest.mark.parametrize("size", SIZES)
def test_execution_order_check_passes(worlds, size):
    counts = {out["order_count"] for out in worlds[size]}
    assert len(counts) == 1 and counts.pop() > 40


@pytest.mark.parametrize("size", SIZES)
def test_distributed_optimizer_negotiated_equals_inline(worlds, size):
    """Bitwise at 2 ranks (each element is one a + b and a halving,
    whatever the packing). At 3 the order gloo sums three rows in
    depends on where an element falls in the packed buffer, so the
    gradients agree within a rounding and the AdamW steps within
    relative 1e-5."""
    outs = worlds[size]
    for out in outs:
        for neg, inl in zip(out["dopt_negotiated"], out["dopt_inline"]):
            for a, b in zip(neg, inl):
                if size == 2:
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for out in outs[1:]:
        for a, b in zip(out["dopt_negotiated"][-1],
                        outs[0]["dopt_negotiated"][-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", SIZES)
def test_bucketed_train_step_stays_off_the_engine(worlds, size):
    outs = worlds[size]
    for out in outs:
        assert out["train_exec_unchanged"]
        assert out["train_losses"] == outs[0]["train_losses"]
        for a, b in zip(out["train_params"], outs[0]["train_params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", SIZES)
def test_negotiated_ops_in_flight_beside_a_bucketed_step(worlds, size):
    """Negotiated allreduces and an object gather on the dispatch
    thread while the caller runs the same bucketed steps again: every
    op gets its host answer, and the steps are bitwise the quiet
    ones."""
    for rank, out in enumerate(worlds[size]):
        assert out["twin_group"]
        assert out["side"]["ar"] == [
            [float(sum(i + r for r in range(size)))] * 256
            for i in range(8)]
        assert out["side"]["obj"] == [("side", r) for r in range(size)]
        assert out["side_losses"] == out["train_losses"]
        for a, b in zip(out["side_params"], out["train_params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", SIZES)
def test_join_with_a_join_aware_average(worlds, size):
    outs = worlds[size]
    assert [out["join"] for out in outs] == [0] * size
    first = outs[0]
    assert first["after_join"] == [10.0] * 3         # one active rank
    assert first["after_join_fp16"] == ("torch.float32", [6.0] * 5)
    assert "join" in first["join_bcast"].lower(), first["join_bcast"]


def test_a_core_that_does_not_build_fails_init_on_every_rank(worlds):
    for out in worlds[2]:
        assert "build of" in out["broken"] and "failed" in out["broken"], \
            out["broken"]
        assert out["recovered"] == [2.0, 2.0]


def test_an_adopted_group_across_hosts_needs_the_control_address(worlds):
    for out in worlds[2]:
        assert "HOROVOD_CONTROL_ADDR" in out["two_hosts"], out["two_hosts"]
