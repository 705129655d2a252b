"""The data-parallel train step of the port (``parallel/train.py`` with a
``data_parallel_mesh``) on gloo worlds of spawned CPU ranks, against the
JAX package's ``build_train_step(overlap=False)`` on a CPU mesh of as
many devices, in this process.

Each rank passes its own batch shard; the reference takes the global
batch, whose shard r its device r computes. Same weights on both sides
(``params_from_jax``), float32 unless named, AdamW with optax's
settings, 3 steps. Both port paths are held against the reference's
monolithic step, which its docstring says is numerically the same as
its bucketed one; at two ranks the port's bucketed step is also held
against the reference's (``overlap=True`` on a ("data",) mesh).

Tolerances. Loss per step and every parameter after 3 steps: relative
1e-5 (the training slice's: float32 sums in other orders through AdamW,
Frobenius norm of the error over that of the reference, each layer's
slice on its own). AdamW makes this measure depend on the weights: an
element whose gradient is near 0 can flip its update's sign on float32
noise, a change of 2 lr. On weights the port draws itself
(``init_params(seed=0)``) one w_up slice of the 3-rank run misses 1e-5
that way, while its step-0 gradient agrees with a float64 computation
to float32 rounding; the weights here are the reference's init, as in
the distributed slice's test. Overlap on and off at two ranks: bitwise equal (a sum
of two addends does not depend on the order, and the 1/2 scale is
exact). fp16 and bf16 wires: each element of the reduced mean gradient
within u (the wire's unit roundoff, 2^-11 or 2^-8) times the sum over
ranks of the contributions' magnitudes, plus n times fp16's smallest
subnormal, 2^-24 (each contribution rounds once to the wire and each
partial sum once, then the mean divides by n); as a Frobenius norm of
the error against the uncompressed step's. The mixed bf16/float32
bucket: relative 2^-7 on both leaves (XLA and PyTorch round the bf16
activations at other places, and both gradients go through them).

The children import torch, numpy and the port, never JAX: this module
imports JAX inside the tests' bodies only.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import numerics as tnum
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import train as ttrain
from test_torch_port_distributed import spawn_world

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128, max_seq=32)
SEQ, BATCH, STEPS, LR = 32, 2, 3, 1e-3
THRESHOLD = 40_000          # bytes: 11 buckets of SMALL's 20 leaves
TOL = 1e-5
UNIT = {"fp16": 2.0 ** -11, "bf16": 2.0 ** -8}
VARIANTS = {"on": dict(overlap=True), "off": dict(overlap=False),
            "fp16": dict(overlap=True, compression="fp16"),
            "bf16": dict(overlap=True, compression="bf16")}


# ---------------------------------------------------------------------------
# Children (module-level, so spawn finds them by name)

def _shard(rank, step, n_batch=BATCH):
    tokens = np.random.RandomState(1000 * step + rank).randint(
        0, SMALL["vocab"], (n_batch, SEQ)).astype(np.int64)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _np(t):
    return t.detach().float().numpy()


def job_world(rank, size, args):
    """One world's checks; the world of 2 (guard on) adds the guard's
    and the small modules' (one thread per rank: the ranks share the
    host's cores)."""
    torch.set_num_threads(1)
    out = {"steps": _steps(rank, size, args)}
    if size == 2:
        out["guard"] = _guard(rank, size, args)
        out["small"] = _small(rank, size)
    return out


def _steps(rank, size, args):
    """Every variant of the step for STEPS steps from the same weights:
    losses, parameters, step 0's reduced gradients and the plan; and
    this rank's own (unreduced) step-0 gradient magnitudes."""
    cfg = ttfm.TransformerConfig(**SMALL, dtype=torch.float32)
    mesh = tmesh.data_parallel_mesh()

    def loss(m, b):
        return ttfm.loss_fn(cfg, m, b)

    out = {"guard": tnum.guard_enabled()}
    for name, kw in VARIANTS.items():
        model = ttfm.params_from_jax(cfg, args["named"], device="cpu")
        opt = ttrain.adamw(model.parameters(), LR)
        step = ttrain.build_train_step(loss, opt, "cpu", mesh=mesh,
                                       overlap_threshold=THRESHOLD, **kw)
        res = {"losses": [], "digests": []}
        for s in range(STEPS):
            metrics = step(model, _shard(rank, s))
            res["losses"].append(float(metrics["loss"]))
            res["digests"].append(tnum.params_digest(model))
            if s == 0:
                res["grads0"] = {n: _np(p.grad)
                                 for n, p in model.named_parameters()}
                res["info"] = ttrain.last_overlap_info()
        res["params"] = ttfm.params_to_jax(cfg, model)
        out[name] = res
    model = ttfm.params_from_jax(cfg, args["named"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _shard(rank, 0).items()}
    ttfm.loss_fn(cfg, model, batch).backward()
    out["local_abs0"] = {n: np.abs(_np(p.grad))
                         for n, p in model.named_parameters()}
    out["shapes"] = [(tuple(p.shape), str(p.dtype).replace("torch.", ""))
                     for p in model.parameters()]
    return out


def _launder(grads):
    return {n: torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
            for n, g in grads.items()}


def _guard(rank, size, args):
    """The guard (HOROVOD_NUMERICS_GUARD=1 at init): a clean step, then
    a step where rank 1's loss is NaN, then a clean step, on both paths
    and behind a reducer that launders NaN."""
    cfg = ttfm.TransformerConfig(**SMALL, dtype=torch.float32)
    mesh = tmesh.data_parallel_mesh()

    def loss(m, b):
        return ttfm.loss_fn(cfg, m, b) * b["scale"]

    out = {}
    for name, kw in (("on", dict(overlap=True)),
                     ("off", dict(overlap=False)),
                     ("on_laundered", dict(overlap=True,
                                           grad_reducer=_launder)),
                     ("off_laundered", dict(overlap=False,
                                            grad_reducer=_launder))):
        model = ttfm.params_from_jax(cfg, args["named"], device="cpu")
        opt = tnum.guard_non_finite(ttrain.adamw(model.parameters(), LR))
        step = ttrain.build_train_step(loss, opt, "cpu", mesh=mesh,
                                       overlap_threshold=THRESHOLD, **kw)

        def batch(s, scale=1.0):
            return dict(_shard(rank, s), scale=np.float32(scale))

        step(model, batch(0))
        state = lambda: tnum.params_digest(  # noqa: E731
            [dict(model.named_parameters()),
             [opt.state[p] for p in model.parameters()]])
        before = state()
        metrics = step(model, batch(1, np.nan if rank == 1 else 1.0))
        skipped = state()
        skips = opt.consecutive_skips
        step(model, batch(2))
        out[name] = {"skip_kept_state": skipped == before,
                     "consecutive_after_skip": skips,
                     "loss_after_skip": float(metrics["loss"]),
                     "applied_after": state() != skipped,
                     "consecutive_after": opt.consecutive_skips,
                     "total_after": opt.total_skips,
                     "is_adamw": isinstance(opt, torch.optim.AdamW),
                     "guard": tnum.guard_enabled()}
    return out


class _W(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3))


class _Mixed(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.wb = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
        self.wf = torch.nn.Parameter(torch.ones(4, 2))


def _mixed_loss(m, b):
    """The reference's ``loss2`` (tests/test_bucketing.py:283)."""
    h = torch.tanh(b["x"][:, None].to(torch.bfloat16) * m.wb[None, :])
    return torch.mean((h.float() @ m.wf) ** 2)


def _small(rank, size):
    """The reducer contract and the mixed bf16/float32 bucket."""
    mesh = tmesh.data_parallel_mesh()
    out = {}
    for overlap in (True, False):
        seen = []

        def reducer(grads):
            seen.append(_np(grads["w"]))
            return {n: g / size for n, g in grads.items()}

        model = _W()
        step = ttrain.build_train_step(
            lambda m, b: b["x"].mean() + m.w.sum(),
            torch.optim.SGD(model.parameters(), lr=1.0), "cpu", mesh=mesh,
            overlap=overlap, overlap_threshold=4, grad_reducer=reducer)
        step(model, {"x": np.arange(2.0) + 2 * rank})
        out[f"reducer_{overlap}"] = {"w": _np(model.w), "seen": seen}
        model = _Mixed()
        step = ttrain.build_train_step(
            _mixed_loss, torch.optim.SGD(model.parameters(), lr=0.1), "cpu",
            mesh=mesh, overlap=overlap, overlap_threshold=1 << 20)
        step(model, {"x": np.arange(2.0, dtype=np.float32) + 2 * rank})
        out[f"mixed_{overlap}"] = {
            "wb": _np(model.wb), "wf": _np(model.wf),
            "info": ttrain.last_overlap_info(),
            "plan": ttrain.plan_overlap(model, mesh, overlap_threshold=1 << 20,
                                        guard=True)}
    return out


# ---------------------------------------------------------------------------
# The reference, in this process

def _ref_tree(named):
    tree = {"layers": {}}
    for key, arr in named.items():
        parts = [p.strip("'") for p in key.strip("[]").split("][")]
        if parts[0] == "layers":
            tree["layers"][parts[1]] = arr
        else:
            tree[parts[0]] = arr
    return tree


def _jmesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), axis_names=("data",))


def _reference_steps(named, n, **kw):
    """The reference's step (monolithic unless ``kw`` says otherwise)
    on a ("data",) mesh of n CPU devices: the losses and the parameters
    after each step, in the JAX layout."""
    import importlib
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu import weights as jweights
    from horovod_tpu.models import transformer as jtfm
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    jcfg = jtfm.TransformerConfig(**SMALL, dtype=jnp.float32, tp_axis=None,
                                  sp_axis=None, ep_axis=None)
    params = jax.tree_util.tree_map(jnp.asarray, _ref_tree(named))
    tx = optax.adamw(LR)
    opt_state = tx.init(params)
    step = jtrain.build_train_step(lambda p, b: jtfm.loss_fn(jcfg, p, b),
                                   tx, _jmesh(n), donate=False,
                                   **dict(dict(overlap=False), **kw))
    losses, history = [], []
    for s in range(STEPS):
        shards = [_shard(r, s) for r in range(n)]
        batch = {k: jnp.asarray(np.concatenate([b[k] for b in shards]))
                 for k in ("tokens", "targets")}
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        history.append({k: np.asarray(v, np.float32)
                        for k, v in jweights.named_leaves(params)})
    return losses, history


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


@pytest.fixture(scope="module")
def named():
    """The reference's seeded init in its layout, float32 (the weights
    of the distributed slice's test too)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu import weights as jweights
    from horovod_tpu.models import transformer as jtfm
    jcfg = jtfm.TransformerConfig(**SMALL, dtype=jnp.float32, tp_axis=None,
                                  sp_axis=None, ep_axis=None)
    return {n: np.asarray(a, np.float32) for n, a in
            jweights.named_leaves(jtfm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))}


@pytest.fixture(scope="module")
def runs(named, tmp_path_factory):
    """The ranks' results of the worlds of 2 (guard on) and 3 (guard
    off), spawned from threads so that this process computes the
    reference's steps meanwhile, each in a thread of its own: {size:
    results}, {size or "bucketed": (losses, parameters)}."""
    results = {}
    stores = {n: tmp_path_factory.mktemp(f"dp{n}") for n in (2, 3)}

    def run(size):
        try:
            results[size] = spawn_world(
                size, job_world, stores[size], timeout=120, named=named,
                overrides={"HOROVOD_NUMERICS_GUARD": size == 2})
        except BaseException as e:  # noqa: BLE001 — raised below
            results[size] = e

    threads = [threading.Thread(target=run, args=(n,)) for n in (2, 3)]
    for t in threads:
        t.start()
    try:
        with ThreadPoolExecutor(3) as pool:      # three compilations
            jobs = {key: pool.submit(_reference_steps, named, n, **kw)
                    for key, n, kw in (
                        (2, 2, {}), (3, 3, {}),
                        ("bucketed", 2, dict(overlap=True,
                                             overlap_threshold=THRESHOLD)))}
            refs = {key: job.result() for key, job in jobs.items()}
    finally:
        for t in threads:
            t.join(timeout=300)
    for n in (2, 3):
        if isinstance(results.get(n), BaseException):
            raise results[n]
    return results, refs


@pytest.fixture(scope="module")
def world(runs):
    """size -> (the ranks' step results, the reference's losses and
    parameters)."""
    results, refs = runs
    return lambda size: ([o["steps"] for o in results[size]], refs[size])


@pytest.mark.parametrize("variant", ["on", "off"])
@pytest.mark.parametrize("size", [2, 3])
def test_steps_match_the_reference(world, size, variant):
    outs, (losses, history) = world(size)
    assert [o["guard"] for o in outs] == [size == 2] * size
    for o in outs:
        assert o[variant]["digests"] == outs[0][variant]["digests"]
        for s, want in enumerate(losses):
            got = o[variant]["losses"][s]
            assert abs(got - want) <= TOL * abs(want), (s, got, want)
    err, leaf = _worst_rel_err(outs[0][variant]["params"], history[-1])
    assert err <= TOL, (leaf, err)


@pytest.mark.parametrize("size", [2, 3])
def test_ranks_load_no_jax(runs, size):
    assert [o["loaded"] for o in runs[0][size]] == [[]] * size


def test_bucketed_step_matches_the_references_bucketed_step(world, runs):
    """On a mesh whose axis is named "data" the reference's own
    bucketed step runs here (its red tests use an axis it does not count
    as a batch axis, ROADMAP C): the port's bucketed step at two ranks
    against it, with the same threshold."""
    outs, _ = world(2)
    losses, history = runs[1]["bucketed"]
    for s, want in enumerate(losses):
        got = outs[0]["on"]["losses"][s]
        assert abs(got - want) <= TOL * abs(want), (s, got, want)
    err, leaf = _worst_rel_err(outs[0]["on"]["params"], history[-1])
    assert err <= TOL, (leaf, err)


def test_overlap_on_and_off_are_bitwise_equal_at_two_ranks(world):
    outs, _ = world(2)
    for o in outs:
        assert o["on"]["digests"] == o["off"]["digests"]
        assert o["on"]["losses"] == o["off"]["losses"]


@pytest.mark.parametrize("wire", ["fp16", "bf16"])
@pytest.mark.parametrize("size", [2, 3])
def test_wire_casts_within_one_rounding(world, size, wire):
    outs, _ = world(size)
    for o in outs:
        assert o[wire]["digests"] == outs[0][wire]["digests"]
        info = o[wire]["info"]
        assert info["compression"] == wire
        assert info["wire_bucket_bytes"] * 2 == info["raw_bucket_bytes"]
        assert info["digest"].endswith(f"|c={wire}")
    exact = outs[0]["on"]["grads0"]
    got = outs[0][wire]["grads0"]
    moved = 0
    for name, ref in exact.items():
        mag = sum(o["local_abs0"][name] for o in outs)
        bound = np.linalg.norm(UNIT[wire] * mag + size * 2.0 ** -24)
        err = np.linalg.norm(got[name] - ref)
        assert err <= bound, (name, err, bound)
        moved = max(moved, err)
    assert moved > 0          # the cast did round


@pytest.mark.parametrize("size", [2, 3])
def test_plan_digest_is_the_references_on_every_rank(world, size):
    import jax.numpy as jnp
    import importlib
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    outs, _ = world(size)
    leaves = [jnp.zeros(shape, getattr(jnp, dt))
              for shape, dt in outs[0]["shapes"]]
    for wire in ("on", "fp16"):
        ref = jtrain.plan_overlap(
            leaves, _jmesh(size), overlap_threshold=THRESHOLD,
            guard=size == 2,
            compression="fp16" if wire == "fp16" else "none")
        for o in outs:
            info = o[wire]["info"]
            assert info["digest"] == ref.digest
            assert info["buckets"] == len(ref.bucket_leaf_indices) == 11
            assert info["bucket_bytes"] == list(ref.bucket_nbytes)


def test_guard_skips_on_every_rank(runs):
    for o in runs[0][2]:
        for name in ("on", "off", "on_laundered", "off_laundered"):
            r = o["guard"][name]
            assert r["guard"] and r["is_adamw"]
            assert r["skip_kept_state"], name
            assert r["consecutive_after_skip"] == 1, name
            assert np.isnan(r["loss_after_skip"]), name
            assert r["applied_after"], name
            assert (r["consecutive_after"], r["total_after"]) == (0, 1), name


@pytest.fixture(scope="module")
def small(runs):
    return [o["small"] for o in runs[0][2]]


def test_reducer_gets_summed_gradients(small):
    """The reference's hand-computed case (tests/test_bucketing.py:
    304-330): d(sum w)/dw = 1 per rank, summed to n, the reducer divides
    by n: a step of exactly -1.0 under SGD(1.0), on both paths."""
    for o in small:
        for overlap in (True, False):
            r = o[f"reducer_{overlap}"]
            assert len(r["seen"]) == 1
            np.testing.assert_array_equal(r["seen"][0], [2.0] * 3)
            np.testing.assert_array_equal(r["w"], [-1.0] * 3)


@pytest.mark.parametrize("overlap", [True, False])
def test_reference_reducer_gets_summed_gradients_on_a_data_mesh(overlap):
    """The target the port follows: on a ("data",) mesh of 8 CPU devices
    both of the reference's paths hand a custom reducer the summed
    gradients (tests/test_bucketing.py:304-330's case, which fails there
    only because its mesh axis "proc" is not a batch axis)."""
    import importlib
    import jax
    import jax.numpy as jnp
    import optax
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    opt = optax.sgd(1.0)
    params = {"w": jnp.zeros(3)}
    step = jtrain.build_train_step(
        lambda p, b: jnp.mean(b) + jnp.sum(p["w"]), opt, _jmesh(8),
        donate=False, overlap=overlap, overlap_threshold=4,
        grad_reducer=lambda g: jax.tree_util.tree_map(lambda x: x / 8.0, g))
    p, _, _ = step(params, opt.init(params), jnp.arange(8.0))
    np.testing.assert_allclose(np.asarray(p["w"]), -1.0, rtol=1e-6)


def test_mixed_dtype_bucket_matches_the_reference(small):
    import importlib
    import jax
    import jax.numpy as jnp
    import optax
    jtrain = importlib.import_module("horovod_tpu.parallel.train")

    def loss2(params, batch):
        h = jnp.tanh(batch[:, None].astype(jnp.bfloat16)
                     * params["wb"][None, :])
        return jnp.mean((h.astype(jnp.float32) @ params["wf"]) ** 2)

    params = {"wb": jnp.ones(4, jnp.bfloat16),
              "wf": jnp.ones((4, 2), jnp.float32)}
    tx = optax.sgd(0.1)
    step = jtrain.build_train_step(loss2, tx, _jmesh(2), overlap=False,
                                   donate=False)
    p, _, _ = step(params, tx.init(params), jnp.arange(4.0, dtype=jnp.float32))
    want_wb = np.asarray(p["wb"].astype(jnp.float32))
    want_wf = np.asarray(p["wf"])
    ref_plan = jtrain.plan_overlap(params, _jmesh(2),
                                   overlap_threshold=1 << 20, guard=True)
    for o in small:
        for overlap in (True, False):
            r = o[f"mixed_{overlap}"]
            np.testing.assert_allclose(r["wb"], want_wb, rtol=2.0 ** -7)
            np.testing.assert_allclose(r["wf"], want_wf, rtol=2.0 ** -7)
            assert tuple(r["plan"]) == tuple(ref_plan)
            assert r["plan"].wire == (
                (("float32", 9, True, None), ("bfloat16", 4, False, (4,))),)
        assert o["mixed_True"]["info"]["buckets"] == 1
        np.testing.assert_array_equal(o["mixed_True"]["wb"],
                                      o["mixed_False"]["wb"])
        np.testing.assert_array_equal(o["mixed_True"]["wf"],
                                      o["mixed_False"]["wf"])


# ---------------------------------------------------------------------------
# In this process

def test_compression_with_overlap_off_raises():
    opt = ttrain.adamw([torch.nn.Parameter(torch.zeros(2))], LR)
    with pytest.raises(ValueError, match="requires the bucketed overlap"):
        ttrain.build_train_step(lambda m, b: 0, opt, "cpu",
                                mesh=tmesh.Mesh({"data": 2}), overlap=False,
                                compression="fp16")


def test_world_of_one_has_no_bucket():
    """A mesh of one rank reduces nothing: 0 buckets, and the same
    parameters as the step without a mesh, bitwise."""
    cfg = ttfm.TransformerConfig(**SMALL, dtype=torch.float32)
    hvd.init()
    try:
        mesh = tmesh.data_parallel_mesh()
        assert mesh.shape == {"data": 1}
        digests = []
        for m in (mesh, None):
            model = ttfm.init_params(cfg, seed=3, device="cpu")
            step = ttrain.build_train_step(
                lambda mm, b: ttfm.loss_fn(cfg, mm, b),
                ttrain.adamw(model.parameters(), LR), "cpu", mesh=m,
                overlap=True)
            for s in range(2):
                step(model, _shard(0, s))
            info = ttrain.last_overlap_info()
            assert info["buckets"] == 0 and info["digest"] == ""
            digests.append(tnum.params_digest(model))
        assert digests[0] == digests[1]
    finally:
        hvd.shutdown()
