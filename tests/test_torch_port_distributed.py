"""Horovod's data-parallel loop in the port, on gloo worlds of spawned
CPU processes, against the JAX package in this process: the eager
collectives (Adasum on the gather route, Sum, Average, broadcast,
prescale/postscale, fp16/bf16 wires) in worlds of 1 to 4 ranks, and the
whole slice, init -> broadcast_parameters ->
DistributedOptimizer(adamw, op=Adasum, compression=fp16) -> 3 steps on 2
ranks, against the reference's functions composed here.

Multi-process hygiene: ranks run only in spawned children, never in the
pytest process; they meet through a ``file://`` store in ``tmp_path``
(no ports to race for between test workers); each process group has a
60 s timeout; the parent drains the results, joins with a timeout and
kills stragglers; a child imports torch, numpy and the port, never JAX
(each child reports what it loaded); nothing is written under the repo.
The JAX package is imported by the tests' bodies in this process only.

Tolerances. Adasum against the reference's gather-route fold with its
Pallas pair combine interpreted (``_tree_fold(rows, use_pallas=True)``
on the gathered rows: ``_adasum_kernel(mesh, n, sig, True)`` itself
raises under this JAX, see ``_ref_fold``) and, in float32, against the
reference's gather kernel with its jnp combine (``_adasum_kernel(mesh,
n, sig, False)`` on a ``proc`` mesh of n of the 8 CPU devices): both
sides fold the same rows in the same tree and sum in float32 in other
orders, so per element relative 1e-5 (absolute 1e-6) in float32 and one
unit in the last place of the wire, 2^-10 (fp16) or 2^-7 (bf16), through
the decompression; against ``adasum_reference`` (float64) relative 1e-4 in
float32 and 1e-2 for 16-bit wires (the rows round to the wire before the
fold). Sum and Average: float32 sums of n rows in another order,
relative 1e-6; through an fp16 wire, the sum of rounded rows rounded
again, 2^-9. Ranks agree bitwise on every result. The slice: loss per
rank and step relative 1e-5, and every parameter after 3 steps relative
1e-5 (Frobenius norm of the error over that of the reference, each
layer's slice on its own), the training slice's tolerance for AdamW
steps: the fp16 wire rounds both sides' gradients in the same place.
"""

import datetime
import os
import queue
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.ops import adasum_kernels as ak
from horovod_tpu_torch.parallel import train as ttrain

N = 37                          # odd length: no row is a multiple of 8
SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128, max_seq=32)
SEQ, BATCH, STEPS, LR = 32, 2, 3, 1e-3
WIRE_RTOL = {"none": 1e-5, "fp16": 2.0 ** -10, "bf16": 2.0 ** -7}
ORACLE_RTOL = {"none": 1e-4, "fp16": 1e-2, "bf16": 1e-2}
FORBIDDEN = ("jax", "jaxlib", "horovod_tpu")


# ---------------------------------------------------------------------------
# Children (module-level, so spawn can find them by name)

def _contribution(rank, n=N, shape=None):
    x = np.random.RandomState(100 + rank).randn(n).astype(np.float32)
    return torch.from_numpy(x if shape is None else x.reshape(shape))


def _np(t):
    return t.detach().float().numpy()


def job_collectives(rank, size, args):
    x = _contribution(rank)
    out = {}
    for wire in ("none", "fp16", "bf16"):
        comp = getattr(hvd.Compression, wire)
        out[f"adasum_{wire}"] = _np(hvd.allreduce(x, op=hvd.Adasum,
                                                  compression=comp))
    out["adasum_scaled"] = _np(hvd.allreduce(
        x, op=hvd.Adasum, prescale_factor=0.5, postscale_factor=3.0))
    y = _contribution(rank + 10, 15, (5, 3))
    z = _contribution(rank + 20, 7).to(torch.bfloat16)
    gx, gy, gz = hvd.grouped_allreduce([x, y, z], op=hvd.Adasum)
    out["grouped"] = [_np(gx), _np(gy), _np(gz)]
    out["grouped_dtypes"] = [str(t.dtype) for t in (gx, gy, gz)]
    out["sum"] = _np(hvd.allreduce(x, op=hvd.Sum))
    out["average"] = _np(hvd.allreduce(x, average=True))
    out["sum_fp16_scaled"] = _np(hvd.allreduce(
        x, op=hvd.Sum, compression=hvd.Compression.fp16,
        prescale_factor=2.0, postscale_factor=0.25))
    t = x.clone()
    hvd.allreduce_(t, op=hvd.Sum)
    out["sum_inplace"] = _np(t)
    out["broadcast"] = _np(hvd.broadcast(x, root_rank=size - 1))
    b = x.clone()
    hvd.broadcast_(b, root_rank=0)
    out["broadcast_inplace"] = _np(b)
    h = hvd.allreduce_async(x, op=hvd.Sum)
    # With size > 1 the negotiated controller completes the op on its
    # own thread: poll turns True once it has, before synchronize.
    deadline = time.monotonic() + 30
    while not hvd.poll(h) and time.monotonic() < deadline:
        time.sleep(0.001)
    assert hvd.poll(h)
    hvd.synchronize(h)
    try:
        hvd.synchronize(h)
        out["released"] = False
    except KeyError:
        out["released"] = True
    out["kernel_launches"] = (ak.launches_partials, ak.launches_scaled_add)
    out["backend"] = hvd.backend()
    return out


def _batch(rank, step):
    tokens = np.random.RandomState(1000 * step + rank).randint(
        0, SMALL["vocab"], (BATCH, SEQ)).astype(np.int64)
    return tokens, np.roll(tokens, -1, axis=1)


def job_train(rank, size, args):
    cfg = ttfm.TransformerConfig(**SMALL, dtype=torch.float32)
    if rank == 0:
        model = ttfm.params_from_jax(cfg, args["named"], device="cpu")
    else:
        model = ttfm.init_params(cfg, seed=rank, device="cpu")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    got = ttfm.params_to_jax(cfg, model)
    broadcast_ok = all(np.array_equal(got[k], args["named"][k])
                       for k in args["named"])
    opt = hvd.DistributedOptimizer(
        ttrain.adamw(model.parameters(), LR),
        named_parameters=model.named_parameters(), op=hvd.Adasum,
        compression=hvd.Compression.fp16)
    out = {"broadcast_ok": broadcast_ok,
           "is_adamw": isinstance(opt, torch.optim.AdamW),
           "losses": [], "params": []}
    for step in range(STEPS):
        tokens, targets = _batch(rank, step)
        opt.zero_grad()
        loss = ttfm.loss_fn(cfg, model, {
            "tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(targets)})
        loss.backward()
        opt.step()
        out["losses"].append(float(loss.detach()))
        out["params"].append(ttfm.params_to_jax(cfg, model))
    return out


JOBS = {"collectives": job_collectives, "train": job_train}


def _rank_main(rank, size, store, results, job, args):
    status, payload = "error", None
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=60))
        hvd.init(config_overrides=args.get("overrides"))
        payload = (JOBS[job] if isinstance(job, str) else job)(rank, size,
                                                                args)
        payload["loaded"] = sorted({m.split(".")[0] for m in sys.modules}
                                   & set(FORBIDDEN))
        status = "ok"
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = traceback.format_exc()
    finally:
        hvd.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()
        results.put((rank, status, payload))


def spawn_world(size, job, tmp_path, timeout=90.0, **args):
    """Run ``job`` (a name in JOBS, or a module-level function of
    another test module) on ``size`` spawned gloo ranks; their results
    in rank order. Raises with the children's tracebacks if any
    failed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / f"store-{getattr(job, '__name__', job)}-{size}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, size, store, results, job, args))
             for r in range(size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < size and time.monotonic() < deadline:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue.Empty:
                if all(not p.is_alive() for p in procs):
                    break
                continue
            got[rank] = (status, payload)
    finally:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()) + 5)
            if p.is_alive():
                p.kill()
                p.join(5)
    errors = {r: v for r, (s, v) in got.items() if s != "ok"}
    assert not errors, errors
    assert sorted(got) == list(range(size)), \
        f"ranks {sorted(got)} of {size} reported before the timeout"
    return [got[r][1] for r in range(size)]


# ---------------------------------------------------------------------------
# The reference, in this process

def _ref_fold(rows, dtype):
    """The reference's gather-route fold with its Pallas pair combine
    (interpreted): ``_tree_fold(rows, use_pallas=True)`` on the gathered
    rows, as the body of ``_adasum_kernel(mesh, n, sig, True)`` runs it.
    That kernel itself raises under this JAX (0.9: pallas_call inside
    shard_map wants ``vma`` on its out_shape), so the fold is called
    here without the shard_map around it."""
    import jax.numpy as jnp
    from horovod_tpu.ops import adasum as jadasum
    out = jadasum._tree_fold([jnp.asarray(r, dtype) for r in rows],
                             use_pallas=True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _ref_gather_kernel(n, rows):
    """Every rank's result of the reference's gather kernel with its jnp
    pair combine, ``_adasum_kernel(mesh, n, sig, False)``, on a ``proc``
    mesh of n of the 8 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu.ops import dispatch
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("proc",))
    jrows = [jnp.asarray(r) for r in rows]
    kern = jadasum._adasum_kernel(mesh, n, dispatch._sig([jrows[0]]), False)
    full = jax.device_put(jnp.stack(jrows), NamedSharding(mesh, P("proc")))
    (out,) = kern(full)
    shards = sorted(out.addressable_shards, key=lambda s: s.index[0].start)
    return [np.asarray(s.data[0]) for s in shards]


def _assert_ranks_equal(outs, key):
    for o in outs[1:]:
        a, b = o[key], outs[0][key]
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_collectives_match_the_reference(size, tmp_path):
    import jax.numpy as jnp
    from horovod_tpu.ops.adasum import adasum_reference
    outs = spawn_world(size, "collectives", tmp_path,
                       overrides={"HOROVOD_ADASUM_PALLAS": "1"})
    xs = [_contribution(r).numpy() for r in range(size)]
    for o in outs:
        assert o["loaded"] == [] and o["backend"] == "gloo"
        assert o["released"] and o["kernel_launches"] == (0, 0)
        assert o["grouped_dtypes"] == ["torch.float32", "torch.float32",
                                       "torch.bfloat16"]
    for key in ("adasum_none", "adasum_fp16", "adasum_bf16", "adasum_scaled",
                "grouped", "sum", "average", "sum_fp16_scaled",
                "sum_inplace", "broadcast", "broadcast_inplace"):
        _assert_ranks_equal(outs, key)
    got = outs[0]
    if size == 1:                   # a world of one is the identity
        for key in ("adasum_none", "adasum_scaled", "sum", "average",
                    "sum_inplace", "broadcast", "broadcast_inplace"):
            want = xs[0] * (1.5 if key == "adasum_scaled" else 1.0)
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        return
    wire_dtypes = {"none": jnp.float32, "fp16": jnp.float16,
                   "bf16": jnp.bfloat16}
    for wire, jdt in wire_dtypes.items():
        np.testing.assert_allclose(got[f"adasum_{wire}"], _ref_fold(xs, jdt),
                                   rtol=WIRE_RTOL[wire],
                                   atol=1e-6 if wire == "none" else 0)
        np.testing.assert_allclose(got[f"adasum_{wire}"],
                                   adasum_reference(xs),
                                   rtol=ORACLE_RTOL[wire],
                                   atol=ORACLE_RTOL[wire])
    gathered = _ref_gather_kernel(size, xs)
    for g in gathered:
        np.testing.assert_allclose(got["adasum_none"], g, rtol=1e-5,
                                   atol=1e-6)
    want = _ref_fold([0.5 * x for x in xs], jnp.float32) * 3.0
    np.testing.assert_allclose(got["adasum_scaled"], want, rtol=1e-5,
                               atol=1e-6)
    ys = [_contribution(r + 10, 15).numpy() for r in range(size)]
    zs = [_np(_contribution(r + 20, 7).to(torch.bfloat16))
          for r in range(size)]
    xy = _ref_fold([np.concatenate([x, y]) for x, y in zip(xs, ys)],
                   jnp.float32)
    np.testing.assert_allclose(got["grouped"][0], xy[:N], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["grouped"][1], xy[N:].reshape(5, 3),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["grouped"][2],
                               _ref_fold(zs, jnp.bfloat16),
                               rtol=WIRE_RTOL["bf16"], atol=0)
    total = np.sum(xs, axis=0, dtype=np.float64)
    np.testing.assert_allclose(got["sum"], total, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["sum_inplace"], total, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["average"], total / size, rtol=1e-6,
                               atol=1e-6)
    wire = [np.asarray(x, np.float16).astype(np.float64) * 2.0 for x in xs]
    np.testing.assert_allclose(got["sum_fp16_scaled"],
                               np.sum(wire, axis=0) * 0.25, rtol=2.0 ** -9,
                               atol=2.0 ** -9)
    np.testing.assert_array_equal(got["broadcast"], xs[size - 1])
    np.testing.assert_array_equal(got["broadcast_inplace"], xs[0])


def _stack_tree(named):
    """The JAX package's parameter tree from params_to_jax's names."""
    tree = {"layers": {}}
    for key, arr in named.items():
        parts = [p.strip("'") for p in key.strip("[]").split("][")]
        if parts[0] == "layers":
            tree["layers"][parts[1]] = arr
        else:
            tree[parts[0]] = arr
    return tree


def _reference_training(named, cfg_kw):
    """The slice composed from the reference's functions: per rank
    jax.value_and_grad(loss_fn) on its batch, Compression.fp16 on each
    gradient tensor (each layer's slice of a stacked leaf on its own, as
    the port's per-parameter tensors), the Pallas-interpreted
    _tree_fold, decompress, optax.adamw."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu.ops.compression import Compression

    jcfg = jtfm.TransformerConfig(**cfg_kw, dtype=jnp.float32, tp_axis=None,
                                  sp_axis=None, ep_axis=None)
    params = jax.tree_util.tree_map(jnp.asarray, _stack_tree(named))
    tx = optax.adamw(LR)
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.loss_fn(jcfg, p, b)))
    # The Pallas pair combine pads every vector with zeros to whole
    # (256, 128) blocks (_pad_2d); padding to one block here first gives
    # the same sums and one compilation for every tensor.
    block = 256 * 128

    def fold(gs):
        wires = [Compression.fp16.compress(g) for g in gs]
        flat = [jnp.pad(w.reshape(-1), (0, block - w.size))
                for w, _ in wires]
        out = jadasum._tree_fold(flat, use_pallas=True)
        out = out[:gs[0].size].reshape(gs[0].shape)
        return Compression.fp16.decompress(out, wires[0][1])

    losses, history = [], []
    for step in range(STEPS):
        per_rank = []
        for rank in range(2):
            tokens, targets = _batch(rank, step)
            loss, g = grad_fn(params, {"tokens": jnp.asarray(tokens),
                                       "targets": jnp.asarray(targets)})
            per_rank.append(g)
            losses.append((rank, step, float(loss)))
        reduced = {k: fold([g[k] for g in per_rank])
                   for k in ("embed", "final_norm")}
        reduced["layers"] = {
            k: jnp.stack([fold([g["layers"][k][i] for g in per_rank])
                          for i in range(cfg_kw["n_layers"])])
            for k in per_rank[0]["layers"]}
        updates, opt_state = tx.update(reduced, opt_state, params)
        params = optax.apply_updates(params, updates)
        history.append(params)
    return losses, history


def _named_of(tree):
    from horovod_tpu import weights as jweights
    return {n: np.asarray(a, np.float32)
            for n, a in jweights.named_leaves(tree)}


def _worst_rel_err(got, ref):
    errs = {}
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        if name.startswith("['layers']"):
            for i in range(r.shape[0]):
                errs[f"{name}[{i}]"] = float(
                    np.linalg.norm(g[i] - r[i]) / np.linalg.norm(r[i]))
        else:
            errs[name] = float(np.linalg.norm(g - r) / np.linalg.norm(r))
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def test_distributed_optimizer_adasum_slice_matches_the_reference(tmp_path):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    jcfg = jtfm.TransformerConfig(**SMALL, dtype=jnp.float32, tp_axis=None,
                                  sp_axis=None, ep_axis=None)
    named = _named_of(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    outs = spawn_world(2, "train", tmp_path, named=named,
                       overrides={"HOROVOD_ADASUM_PALLAS": "1"})
    for o in outs:
        assert o["loaded"] == [] and o["broadcast_ok"] and o["is_adamw"]
    for step in range(STEPS):             # ranks bitwise equal every step
        for key, arr in outs[0]["params"][step].items():
            np.testing.assert_array_equal(outs[1]["params"][step][key], arr,
                                          err_msg=f"step {step} {key}")
    losses, history = _reference_training(named, SMALL)
    for rank, step, want in losses:
        got = outs[rank]["losses"][step]
        assert abs(got - want) <= 1e-5 * abs(want), (rank, step, got, want)
    err, leaf = _worst_rel_err(outs[0]["params"][-1], _named_of(history[-1]))
    assert err <= 1e-5, (leaf, err)
    moved, _ = _worst_rel_err(outs[0]["params"][-1], named)
    assert moved > 1e-4                    # the steps did update


# ---------------------------------------------------------------------------
# In this process: no ranks, no process group.

def test_ops_before_init_raise_naming_init():
    assert not hvd.is_initialized()
    for call in (lambda: hvd.allreduce(torch.ones(2)),
                 lambda: hvd.broadcast(torch.ones(2), 0),
                 lambda: hvd.rank(), lambda: hvd.size()):
        with pytest.raises(RuntimeError, match="init"):
            call()


@pytest.mark.parametrize("local_size,cuda,cards,want", [
    (1, False, 0, "gloo"),          # no card
    (4, False, 0, "gloo"),
    (1, True, 1, "nccl"),           # a card per rank
    (4, True, 4, "nccl"),
    (2, True, 1, "gloo"),           # two ranks share one card
    (8, True, 4, "gloo"),
])
def test_backend_choice(local_size, cuda, cards, want, monkeypatch):
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert basics.choose_backend(local_size, cuda, cards) == want


def test_init_needs_a_coordinator_for_a_launched_world(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="HOROVOD_COORDINATOR_ADDR"):
        hvd.init(config_overrides={"HOROVOD_RANK": 0, "HOROVOD_SIZE": 2})
    assert not hvd.is_initialized()


def test_distributed_optimizer_is_a_subclass_of_the_wrapped_class():
    hvd.init()
    try:
        p = torch.nn.Parameter(torch.ones(3))
        opt = hvd.DistributedOptimizer(torch.optim.AdamW([p], lr=0.1),
                                       op=hvd.Adasum)
        assert isinstance(opt, torch.optim.AdamW)
        assert type(opt).__name__ == "DistributedAdamW"
        (p * 2).sum().backward()
        with pytest.raises(RuntimeError, match="in flight"):
            opt.zero_grad()
        opt.step()
        assert torch.all(p < 1)
        with pytest.raises(ValueError, match="already"):
            hvd.DistributedOptimizer(opt)
    finally:
        hvd.shutdown()


def test_process_sets_other_than_global_raise(monkeypatch):
    """What raises: a PowerSGD rank below 1 (the reference's check), and
    the process-set errors of the reference (duplicate ranks, ranks out
    of range, an unregistered set, a rank outside the set, removing the
    global set). The gloo worlds of tests/test_torch_port_collectives.py
    run the sets themselves."""
    from horovod_tpu_torch.common.topology import Topology
    from horovod_tpu_torch.ops.process_set import ProcessSetTable
    assert hvd.Compression.powersgd(rank=2).rank == 2
    with pytest.raises(ValueError, match="rank must be >= 1"):
        hvd.Compression.powersgd(rank=0)
    with pytest.raises(ValueError, match="duplicate"):
        hvd.ProcessSet([0, 0])
    with pytest.raises(ValueError, match="out of range"):
        hvd.init(process_sets=[hvd.ProcessSet([0, 1])])
    assert not hvd.is_initialized()
    hvd.init(process_sets=[hvd.ProcessSet([0])])
    try:
        with pytest.raises(ValueError, match="out of range"):
            hvd.add_process_set([0, 3])
        with pytest.raises(ValueError, match="not registered"):
            hvd.allreduce(torch.ones(2), process_set=hvd.ProcessSet([0]))
        with pytest.raises(ValueError, match="global"):
            hvd.remove_process_set(hvd.global_process_set())
        assert hvd.add_process_set([0]) is hvd.global_process_set()
        assert hvd.process_set_included(0)
        table = ProcessSetTable(Topology(rank=1, size=2, local_rank=1,
                                         local_size=2))
        outside = table.register(hvd.ProcessSet([0]))
        monkeypatch.setattr(basics.state(), "process_set_table", table)
        with pytest.raises(ValueError, match="not a member"):
            hvd.allreduce(torch.ones(2), process_set=outside)
        with pytest.raises(ValueError, match="not a member"):
            hvd.allgather(torch.ones(2), process_set=outside)
    finally:
        monkeypatch.undo()
        hvd.shutdown()


def test_children_import_no_jax():
    """The spawned children import this module: it must not import JAX
    at its top level."""
    assert "jax" not in _module_imports()


def _module_imports():
    import ast
    with open(os.path.abspath(__file__), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_distributed_optimizer_is_freed_with_its_model():
    """Dropping the model and the optimizer frees both: the gradient
    hooks the optimizer puts on the parameters do not keep it alive."""
    import gc
    import weakref
    hvd.init()
    try:
        model = torch.nn.Linear(3, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        refs = [weakref.ref(x) for x in (opt, next(model.parameters()))]
        del model, opt
        gc.collect()
        assert [r() for r in refs] == [None, None]
    finally:
        hvd.shutdown()
