"""Adasum's vhdd route and the other collectives and process sets of the
port, against the JAX package on the CPU.

Simulated ranks: ``ops.adasum.vhdd`` runs in n threads of this process
(n = 2 ... 8), each with a wire that hands messages between the threads,
and is held against the reference's ``_adasum_kernel_vhdd`` on a
``proc`` mesh of n of the 8 CPU devices and against the float64
``adasum_reference``: float32, float64, float16 and bfloat16 buckets,
the kernel branch (K1/K2's plain versions on CPU tensors), grouped
tensors, a zero norm, and what every rank sends.

Spawned gloo worlds of 2, 3 and 4 ranks run every case of the slice
once per world size: Adasum under default knobs (vhdd) and its
``DistributedOptimizer``, allgather with uneven first dims (and bool),
alltoall with uneven splits, reducescatter with a remainder, their
grouped forms, Min, Max and Product with prescale and postscale,
``allgather_object``, ``barrier`` and, in the 3- and 4-rank worlds,
process sets. They are held against the reference's kernels of
``dispatch.allgather``, ``alltoall``, ``reducescatter``,
``reducescatter_group`` and the Min/Max/Product allreduce
(``_allgather_kernel``, ``_alltoall_kernel``, ``_reducescatter_kernel``,
``_reducescatter_group_kernel``, ``_allreduce_kernel``) on the CPU mesh.
The children follow ``spawn_world``'s hygiene
(tests/test_torch_port_distributed.py) and import no JAX.

Tolerances. Ranks agree bitwise on every result. float32 vhdd against
the reference kernel: per element relative 1e-5, absolute 1e-5 (both
sum the partials in float32, in other orders; seen: 1e-6), and against
``adasum_reference`` relative 1e-4, absolute 1e-5 (the reference test's).
float64: relative 1e-12 against the reference kernel (the coefficients
are float32 on both sides; seen: 1e-16). float16 and bfloat16 buckets:
the norm of the error over the reference kernel's norm at most 2^-9 and
2^-6: the port rounds each product and the sum of a blend to the dtype,
where XLA's CPU fusion rounds once, one unit in the last place (2^-11,
2^-8) per blend and at most four blends at n <= 8 (seen: 6.4e-4 and
0). ``_partial_dots``: relative 1e-6, and 1e-6 |a| |b| absolute (the
scale of a float32 dot product's rounding). The gloo worlds: Adasum as
above; allgather, alltoall, Min and Max
exact; Sum, Average and Product of float32 rows relative 1e-6 (another
summation order), integer Product exact.
"""

import queue
import threading

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum as tadasum
from horovod_tpu_torch.ops import adasum_kernels as ak
from horovod_tpu_torch.ops.process_set import ProcessSet, ProcessSetTable
from horovod_tpu_torch.common.topology import Topology
from test_torch_port_distributed import spawn_world

TORCH = {"float32": torch.float32, "float64": torch.float64,
         "float16": torch.float16, "bfloat16": torch.bfloat16}
NORM_TOL = {"float16": 2.0 ** -9, "bfloat16": 2.0 ** -6}


# ---------------------------------------------------------------------------
# Simulated ranks: threads of this process

class _Hub:
    """What the threads of one simulated world share."""

    def __init__(self, n):
        self.n = n
        self.boxes = {(s, d): queue.Queue() for s in range(n)
                      for d in range(n)}
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.unions = {ra: (threading.Barrier(n - ra), [None] * n)
                       for ra in range(n)}


class SimWire:
    """``vhdd``'s wire between threads: the same messages as
    ``_DistWire``, and the merge's masked sum in member order."""

    def __init__(self, hub, me):
        self.hub, self.me, self.sent = hub, me, []

    def swap(self, send, partner):
        self.sent.append(("swap", send.numel()))
        self.hub.boxes[(self.me, partner)].put(send.clone())
        return self.hub.boxes[(partner, self.me)].get(timeout=30)

    def partials(self, part):
        self.sent.append(("partials", part.numel()))
        self.hub.slots[self.me] = part.clone()
        self.hub.barrier.wait(30)
        rows = torch.stack(self.hub.slots)
        self.hub.barrier.wait(30)
        return rows

    def merge(self, seg, ra, rb):
        barrier, slots = self.hub.unions[ra]
        both = torch.zeros((2,) + tuple(seg.shape), dtype=seg.dtype)
        if self.me in (ra, rb):
            both[0 if self.me == ra else 1] = seg
        self.sent.append(("merge", both.numel()))
        slots[self.me] = both
        barrier.wait(30)
        total = slots[ra]
        for i in range(ra + 1, self.hub.n):
            total = total + slots[i]
        barrier.wait(30)
        return total[0], total[1]


class _SimSet:
    def __init__(self, n, me):
        self.size, self._me = n, me

    def rank(self):
        return self._me


def simulate(groups, monkeypatch, prescale=1.0, postscale=1.0):
    """``adasum_allreduce(groups[r], ...)`` on simulated rank r for
    every r, each on its own thread; returns (outputs, wires)."""
    n = len(groups)
    hub = _Hub(n)
    wires = [SimWire(hub, r) for r in range(n)]
    monkeypatch.setattr(tadasum, "_DistWire",
                        lambda pset: wires[pset.rank()])
    outs, errors = [None] * n, []

    def run(r):
        try:
            outs[r] = tadasum.adasum_allreduce(groups[r], _SimSet(n, r),
                                               prescale, postscale)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return outs, wires


def simulate_kernel_branch(xs):
    """``vhdd(..., use_kernel=True)`` on simulated ranks: the K1/K2
    branch, which on CPU tensors runs the kernels' plain versions."""
    n = len(xs)
    hub = _Hub(n)
    pad = (-xs[0].numel()) % tadasum._pow2_blocks(n)[0][1]
    outs = [None] * n

    def run(r):
        seg = torch.cat([xs[r], xs[r].new_zeros(pad)])
        outs[r] = tadasum.vhdd(seg, r, n, SimWire(hub, r),
                               True)[:xs[r].numel()]

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return outs


def ref_vhdd(rows_per_tensor, jdtype):
    """Every rank's outputs of the reference's ``_adasum_kernel_vhdd``
    on a ``proc`` mesh of n CPU devices: ``rows_per_tensor[t][r]`` is
    rank r's tensor t. float64 numpy arrays, per rank a list."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu.ops import dispatch
    n = len(rows_per_tensor[0])
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("proc",))
    stacks = [jnp.asarray(np.stack(rows), jdtype) for rows in rows_per_tensor]
    kern = jadasum._adasum_kernel_vhdd(mesh, n,
                                       dispatch._sig([s[0] for s in stacks]))
    outs = kern(*[jax.device_put(s, NamedSharding(mesh, P("proc")))
                  for s in stacks])
    per_rank = [[] for _ in range(n)]
    for o in outs:
        for s in o.addressable_shards:
            per_rank[s.index[0].start].append(
                np.asarray(jnp.asarray(s.data[0], jnp.float64)))
    return per_rank


def _f64(t):
    return t.detach().to(torch.float64).numpy()


def _assert_ranks_equal(outs):
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", range(2, 9))
def test_vhdd_matches_the_reference_float32(n, monkeypatch):
    from horovod_tpu.ops.adasum import adasum_reference
    rng = np.random.RandomState(23 + n)
    xs = rng.randn(n, 53).astype(np.float32)          # odd length: pads
    outs, wires = simulate([[torch.from_numpy(x.copy())] for x in xs],
                           monkeypatch)
    _assert_ranks_equal(outs)
    want = ref_vhdd([list(xs)], np.float32)
    oracle = adasum_reference(list(xs))
    for r in range(n):
        assert outs[r][0].dtype == torch.float32
        np.testing.assert_allclose(_f64(outs[r][0]), want[r][0], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_f64(outs[r][0]), oracle, rtol=1e-4,
                                   atol=1e-5)
    # The kernel branch (K1's partials, a fresh stats tensor, K2).
    kern = simulate_kernel_branch([torch.from_numpy(x.copy()) for x in xs])
    for r in range(n):
        assert torch.equal(kern[r], kern[0])
        np.testing.assert_allclose(_f64(kern[r]), want[r][0], rtol=1e-5,
                                   atol=1e-5)
    # The wire: no gather of the bucket, three floats per partials
    # message, and in a power-of-two world no message above half the
    # padded bucket; a merge carries two padded buckets.
    block = tadasum._pow2_blocks(n)[0][1]
    padded = 53 + (-53) % block
    for w in wires:
        kinds = {k for k, _ in w.sent}
        assert kinds <= {"swap", "partials", "merge"}
        assert all(m == 3 for k, m in w.sent if k == "partials")
        assert all(m <= padded // 2 for k, m in w.sent if k == "swap")
        assert all(m == 2 * padded for k, m in w.sent if k == "merge")
        if n & (n - 1) == 0:
            assert "merge" not in kinds


@pytest.mark.parametrize("dtype", ["float64", "float16", "bfloat16"])
@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_vhdd_matches_the_reference_in_other_dtypes(n, dtype, monkeypatch):
    import jax.numpy as jnp
    rng = np.random.RandomState(5 * n)
    xs = [torch.from_numpy(x).to(TORCH[dtype])
          for x in rng.randn(n, 301).astype(np.float64)]
    outs, _ = simulate([[x] for x in xs], monkeypatch)
    _assert_ranks_equal(outs)
    want = ref_vhdd([[_f64(x) for x in xs]], getattr(jnp, dtype))
    for r in range(n):
        got = outs[r][0]
        assert got.dtype == TORCH[dtype]
        if dtype == "float64":
            np.testing.assert_allclose(_f64(got), want[r][0], rtol=1e-12)
        else:
            err = np.linalg.norm(_f64(got) - want[r][0]) \
                / np.linalg.norm(want[r][0])
            assert err <= NORM_TOL[dtype], err


def test_vhdd_grouped_tensors_and_scales(monkeypatch):
    n = 4
    rng = np.random.RandomState(11)
    a = rng.randn(n, 5).astype(np.float32)
    b = rng.randn(n, 3, 2).astype(np.float32)
    groups = [[torch.from_numpy(a[r].copy()), torch.from_numpy(b[r].copy())]
              for r in range(n)]
    outs, _ = simulate(groups, monkeypatch, prescale=0.5, postscale=3.0)
    _assert_ranks_equal(outs)
    want = ref_vhdd([list(0.5 * a), list(0.5 * b)], np.float32)
    for r in range(n):
        assert outs[r][0].shape == (5,) and outs[r][1].shape == (3, 2)
        np.testing.assert_allclose(_f64(outs[r][0]), 3.0 * want[r][0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f64(outs[r][1]), 3.0 * want[r][1],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_vhdd_zero_norm(n, monkeypatch):
    from horovod_tpu.ops.adasum import adasum_reference
    rng = np.random.RandomState(n)
    xs = rng.randn(n, 40).astype(np.float32)
    xs[0] = 0.0
    outs, _ = simulate([[torch.from_numpy(x.copy())] for x in xs],
                       monkeypatch)
    want = ref_vhdd([list(xs)], np.float32)
    for r in range(n):
        assert torch.isfinite(outs[r][0]).all()
        np.testing.assert_allclose(_f64(outs[r][0]), want[r][0], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_f64(outs[r][0]),
                                   adasum_reference(list(xs)), rtol=1e-4,
                                   atol=1e-5)


def test_pow2_blocks_match_the_reference():
    from horovod_tpu.ops import adasum as jadasum
    for n in range(1, 40):
        assert tadasum._pow2_blocks(n) == jadasum._pow2_blocks(n)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_partial_dots_match_the_reference(dtype):
    import jax.numpy as jnp
    from horovod_tpu.ops import adasum as jadasum
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.randn(999)).to(TORCH[dtype])
            for _ in range(2))
    got = tadasum._partial_dots(a, b)
    want = jadasum._partial_dots(jnp.asarray(_f64(a), getattr(jnp, dtype)),
                                 jnp.asarray(_f64(b), getattr(jnp, dtype)))
    assert got.dtype == torch.float32 and got.shape == (3,)
    want = np.asarray(want, np.float64)
    # A dot product's rounding error scales with |a| |b|, not with a.b.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.sqrt(want[1] * want[2]))


# ---------------------------------------------------------------------------
# Spawned gloo worlds

def _x(rank, rows, cols=3, seed=0, dtype=torch.float32):
    x = np.random.RandomState(seed + 17 * rank).randn(rows, cols)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _np(t):
    return t.detach().numpy() if t.dtype != torch.bfloat16 else \
        t.detach().float().numpy()


def _splits(rank, size):
    return [(rank + 2 * j) % 3 for j in range(size)]


def job_slice(rank, size, args):
    """Every case of the slice on this rank; numpy results."""
    import torch.distributed as dist
    gathers = []
    real_all_gather = dist.all_gather

    def counting_all_gather(tensor_list, tensor, *a, **kw):
        gathers.append(tensor.numel())
        return real_all_gather(tensor_list, tensor, *a, **kw)

    out = {}
    x = _x(rank, 37, 1).reshape(-1)
    dist.all_gather = counting_all_gather
    try:
        out["adasum"] = _np(hvd.allreduce(x, op=hvd.Adasum))
        out["adasum_fp16"] = _np(hvd.allreduce(
            x, op=hvd.Adasum, compression=hvd.Compression.fp16))
    finally:
        dist.all_gather = real_all_gather
    out["adasum_gathers"] = gathers
    out["adasum_launches"] = (ak.launches_partials, ak.launches_scaled_add)
    # DistributedOptimizer under default knobs (vhdd).
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 4)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    for step in range(2):
        opt.zero_grad()
        model(_x(rank, 5, 6, seed=step)).square().sum().backward()
        opt.step()
    out["model"] = [_np(p) for p in model.parameters()]
    # allgather: uneven first dims, a bool tensor, a 0-d tensor.
    out["allgather"] = _np(hvd.allgather(_x(rank, rank + 1)))
    out["allgather_bool"] = _np(hvd.allgather(
        torch.arange(rank + 2) % 2 == 0))
    out["allgather_scalar"] = _np(hvd.allgather(torch.tensor(float(rank))))
    ga, gb = hvd.grouped_allgather([_x(rank, rank + 2, 2, seed=1),
                                    _x(rank, 2, 5, seed=2)])
    out["grouped_allgather"] = [_np(ga), _np(gb)]
    # alltoall: uneven splits, and even without splits.
    splits = _splits(rank, size)
    rows = _x(rank, sum(splits), 2, seed=3)
    got, recv = hvd.alltoall(rows, splits=splits)
    out["alltoall"], out["alltoall_recv"] = _np(got), recv.tolist()
    out["alltoall_recv_dtype"] = str(recv.dtype)
    out["alltoall_even"] = _np(hvd.alltoall(_x(rank, 2 * size, 2, seed=4)))
    # reducescatter: a remainder, Sum and Average with scales.
    d0 = 2 * size + 1
    out["rs_sum"] = _np(hvd.reducescatter(_x(rank, d0, 3, seed=5),
                                          op=hvd.Sum))
    out["rs_avg"] = _np(hvd.reducescatter(
        _x(rank, d0, 3, seed=5), op=hvd.Average, prescale_factor=0.5,
        postscale_factor=3.0))
    ra, rb = hvd.grouped_reducescatter([_x(rank, d0, 3, seed=6),
                                        _x(rank, size + 2, 2, seed=7)],
                                       op=hvd.Sum)
    out["grouped_rs"] = [_np(ra), _np(rb)]
    # Min, Max, Product with prescale and postscale; integer Product.
    m = _x(rank, 4, 3, seed=8)
    for name, op in (("min", hvd.Min), ("max", hvd.Max),
                     ("product", hvd.Product)):
        out[name] = _np(hvd.allreduce(m, op=op, prescale_factor=2.0,
                                      postscale_factor=0.5))
    ints = torch.tensor([rank + 1, 2, -1], dtype=torch.int32)
    prod = hvd.allreduce(ints, op=hvd.Product)
    out["product_int"], out["product_int_dtype"] = _np(prod), str(prod.dtype)
    out["objects"] = hvd.allgather_object({"rank": rank, "pad": "x" * rank})
    hvd.barrier()
    # Process sets: registered on every rank in the same order.
    if size >= 3:
        pair = hvd.add_process_set([0, 2])
        out["pair_id"] = pair.process_set_id
        out["pair_included"] = hvd.process_set_included(pair.process_set_id)
        out["pair_rank"] = pair.rank()
        if pair.included():
            px = _x(rank, 21, 1, seed=9).reshape(-1)
            out["pair_sum"] = _np(hvd.allreduce(px, op=hvd.Sum,
                                                process_set=pair))
            out["pair_adasum"] = _np(hvd.allreduce(px, op=hvd.Adasum,
                                                   process_set=pair))
            out["pair_allgather"] = _np(hvd.allgather(
                _x(rank, rank + 1), process_set=pair))
            hvd.barrier(process_set=pair)
        else:
            try:
                hvd.allreduce(torch.ones(2), process_set=pair)
                out["pair_refused"] = False
            except ValueError:
                out["pair_refused"] = True
    if size == 4:
        trio = hvd.add_process_set([1, 2, 3])
        if trio.included():
            tx = _x(rank, 29, 1, seed=10).reshape(-1)
            out["trio_adasum"] = _np(hvd.allreduce(tx, op=hvd.Adasum,
                                                   process_set=trio))
        hvd.remove_process_set(trio)
        out["trio_removed"] = trio.process_set_id is None
    return out


def _ref_mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), axis_names=("proc",))


def _ref_run(kern, mesh, per_rank):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    full = jax.device_put(jnp.stack([jnp.asarray(x) for x in per_rank]),
                          NamedSharding(mesh, P("proc")))
    out = kern(full)
    out = out[0] if isinstance(out, (tuple, list)) else out
    return [np.asarray(s.data[0]) for s in
            sorted(out.addressable_shards, key=lambda s: s.index[0].start)]


def _ref_allgather(mesh, xs):
    from horovod_tpu.ops import dispatch
    n = len(xs)
    rows = tuple(x.shape[0] for x in xs)
    maxr = max(rows)
    padded = [np.concatenate([x, np.zeros((maxr - x.shape[0],)
                                          + x.shape[1:], x.dtype)])
              for x in xs]
    kern = dispatch._allgather_kernel(mesh, n, rows,
                                      dispatch._sig([padded[0]]))
    return _ref_run(kern, mesh, padded)


def _ref_reducescatter(mesh, xs, op, prescale=1.0, postscale=1.0):
    from horovod_tpu.ops import dispatch
    n = len(xs)
    rows = dispatch.reducescatter_rows(xs[0].shape[0], n)
    kern = dispatch._reducescatter_kernel(mesh, n, op, prescale, postscale,
                                          rows, dispatch._sig([xs[0]]))
    return [o[:rows[r]] for r, o in enumerate(_ref_run(kern, mesh, xs))]


def _check_world(size, outs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from horovod_tpu.ops import dispatch
    from horovod_tpu.ops.dispatch import AVERAGE, MAX, MIN, PRODUCT, SUM
    mesh = _ref_mesh(size)
    for o in outs:
        assert o["loaded"] == []
    for key in outs[0]:
        if key.startswith("pair") or key.startswith("trio"):
            continue
        for o in outs[1:]:
            if key in ("allgather", "allgather_bool", "allgather_scalar",
                       "grouped_allgather", "adasum", "adasum_fp16",
                       "model", "min", "max", "product", "product_int",
                       "objects", "adasum_launches"):
                np.testing.assert_equal(o[key], outs[0][key], err_msg=key)
    # Adasum (vhdd under default knobs): no gather of the bucket, and
    # the CPU runs no kernel.
    xs = [_x(r, 37, 1).reshape(-1).numpy() for r in range(size)]
    want = ref_vhdd([xs], np.float32)
    for r, o in enumerate(outs):
        assert max(o["adasum_gathers"]) <= 3, o["adasum_gathers"]
        assert o["adasum_launches"] == (0, 0)
        np.testing.assert_allclose(o["adasum"], want[r][0], rtol=1e-5,
                                   atol=1e-5)
    wire = [np.asarray(x, np.float16).astype(np.float64) for x in xs]
    want16 = ref_vhdd([wire], jnp.float16)[0][0]
    err = np.linalg.norm(outs[0]["adasum_fp16"] - want16) / \
        np.linalg.norm(want16)
    assert err <= NORM_TOL["float16"], err
    # allgather
    for key, per_rank in (
            ("allgather", [_x(r, r + 1).numpy() for r in range(size)]),
            ("allgather_bool", [(np.arange(r + 2) % 2 == 0).astype(np.uint8)
                                for r in range(size)]),
            ("allgather_scalar", [np.array([float(r)], np.float32)
                                  for r in range(size)])):
        want = _ref_allgather(mesh, per_rank)[0]
        got = outs[0][key]
        if key == "allgather_bool":
            assert got.dtype == np.bool_
            got = got.astype(np.uint8)
        np.testing.assert_array_equal(got, want, err_msg=key)
    for i, (rows_of, cols, seed) in enumerate(((lambda r: r + 2, 2, 1),
                                               (lambda r: 2, 5, 2))):
        want = _ref_allgather(mesh, [_x(r, rows_of(r), cols, seed).numpy()
                                     for r in range(size)])[0]
        np.testing.assert_array_equal(outs[0]["grouped_allgather"][i], want)
    # alltoall
    mat = [_splits(r, size) for r in range(size)]
    maxsplit = max(max(row) for row in mat)
    packed = []
    for r in range(size):
        rows = _x(r, sum(mat[r]), 2, seed=3).numpy()
        chunks, off = [], 0
        for s in mat[r]:
            c = rows[off:off + s]
            chunks.append(np.concatenate([c, np.zeros((maxsplit - s, 2),
                                                      np.float32)]))
            off += s
        packed.append(np.stack(chunks))
    kern = dispatch._alltoall_kernel(mesh, size, maxsplit,
                                     dispatch._sig([packed[0]]))
    received = _ref_run(kern, mesh, packed)
    for r, o in enumerate(outs):
        recv = [mat[src][r] for src in range(size)]
        want = np.concatenate([received[r][i, :recv[i]]
                               for i in range(size)])
        np.testing.assert_array_equal(o["alltoall"], want)
        assert o["alltoall_recv"] == recv
        assert o["alltoall_recv_dtype"] == "torch.int32"
        even = [_x(s, 2 * size, 2, seed=4).numpy()[2 * r:2 * r + 2]
                for s in range(size)]
        np.testing.assert_array_equal(o["alltoall_even"],
                                      np.concatenate(even))
    # reducescatter
    d0 = 2 * size + 1
    xs5 = [_x(r, d0, 3, seed=5).numpy() for r in range(size)]
    for key, op, pre, post in (("rs_sum", SUM, 1.0, 1.0),
                               ("rs_avg", AVERAGE, 0.5, 3.0)):
        want = _ref_reducescatter(mesh, xs5, op, pre, post)
        for r, o in enumerate(outs):
            assert o[key].shape == want[r].shape, key
            np.testing.assert_allclose(o[key], want[r], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    ta = [_x(r, d0, 3, seed=6).numpy() for r in range(size)]
    tb = [_x(r, size + 2, 2, seed=7).numpy() for r in range(size)]
    rows_a = tuple(dispatch.reducescatter_rows(d0, size))
    rows_b = tuple(dispatch.reducescatter_rows(size + 2, size))
    kern = dispatch._reducescatter_group_kernel(
        mesh, size, SUM, 1.0, 1.0, (rows_a, rows_b),
        dispatch._sig([ta[0], tb[0]]))
    ga, gb = kern(*[jax.device_put(jnp.stack(t), NamedSharding(mesh,
                                                               P("proc")))
                    for t in (ta, tb)])
    for r, o in enumerate(outs):
        for got, g, rows in ((o["grouped_rs"][0], ga, rows_a),
                             (o["grouped_rs"][1], gb, rows_b)):
            shard = next(s for s in g.addressable_shards
                         if s.index[0].start == r)
            want = np.asarray(shard.data[0])[:rows[r]]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # Min, Max, Product
    ms = [_x(r, 4, 3, seed=8).numpy() for r in range(size)]
    for key, op in (("min", MIN), ("max", MAX), ("product", PRODUCT)):
        kern = dispatch._allreduce_kernel(mesh, size, op, 2.0, 0.5,
                                          dispatch._sig([ms[0]]))
        want = _ref_run(kern, mesh, ms)[0]
        if op == PRODUCT:
            np.testing.assert_allclose(outs[0][key], want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(outs[0][key], want)
    ints = [np.array([r + 1, 2, -1], np.int32) for r in range(size)]
    kern = dispatch._allreduce_kernel(mesh, size, PRODUCT, 1.0, 1.0,
                                      dispatch._sig([ints[0]]))
    np.testing.assert_array_equal(outs[0]["product_int"],
                                  _ref_run(kern, mesh, ints)[0])
    assert outs[0]["product_int_dtype"] == "torch.int32"
    assert outs[0]["objects"] == [{"rank": r, "pad": "x" * r}
                                  for r in range(size)]
    # Sets
    if size >= 3:
        pair = [0, 2]
        for r, o in enumerate(outs):
            assert o["pair_id"] == 1
            assert o["pair_included"] == (r in pair)
            assert o["pair_rank"] == (pair.index(r) if r in pair else -1)
            if r not in pair:
                assert o["pair_refused"] is True
        px = [_x(r, 21, 1, seed=9).reshape(-1).numpy() for r in pair]
        np.testing.assert_array_equal(outs[0]["pair_adasum"],
                                      outs[2]["pair_adasum"])
        np.testing.assert_allclose(outs[0]["pair_sum"], px[0] + px[1],
                                   rtol=1e-6)
        np.testing.assert_allclose(outs[0]["pair_adasum"],
                                   ref_vhdd([px], np.float32)[0][0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            outs[2]["pair_allgather"],
            np.concatenate([_x(r, r + 1).numpy() for r in pair]))
    if size == 4:
        trio = [1, 2, 3]
        tx = [_x(r, 29, 1, seed=10).reshape(-1).numpy() for r in trio]
        want = ref_vhdd([tx], np.float32)[0][0]
        for r in trio:
            np.testing.assert_array_equal(outs[r]["trio_adasum"],
                                          outs[1]["trio_adasum"])
            np.testing.assert_allclose(outs[r]["trio_adasum"], want,
                                       rtol=1e-5, atol=1e-5)
        assert all(o["trio_removed"] for o in outs)


@pytest.mark.parametrize("size", [2, 3, 4])
def test_slice_matches_the_reference_on_gloo(size, tmp_path):
    _check_world(size, spawn_world(size, job_slice, tmp_path))


# ---------------------------------------------------------------------------
# In this process: registration without a process group

def test_set_table_registration():
    table = ProcessSetTable(Topology(rank=1, size=4, local_rank=1,
                                     local_size=4))
    assert table.ids() == [0] and table.global_set.ranks == [0, 1, 2, 3]
    pair = table.register(ProcessSet([2, 0]))
    assert pair.ranks == [0, 2] and pair.process_set_id == 1
    assert table.register(ProcessSet([0, 2])) is pair     # reused
    assert pair.rank() == -1 and not pair.included()
    assert table.global_set.rank() == 1 and table.global_set.included()
    assert table.get(1) is pair and table.ids() == [0, 1]
    with pytest.raises(ValueError, match="out of range"):
        table.register(ProcessSet([3, 4]))
    with pytest.raises(ValueError, match="global"):
        table.remove(table.global_set)
    table.remove(pair)
    assert pair.process_set_id is None and table.ids() == [0]
    with pytest.raises(ValueError, match="duplicate"):
        ProcessSet([1, 1])
    with pytest.raises(RuntimeError, match="not registered"):
        ProcessSet([0]).rank()
