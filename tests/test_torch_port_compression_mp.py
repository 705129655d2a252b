"""PowerSGD on both of the port's reduction planes, on gloo worlds of 2
(guard on) and 3 (guard off) spawned CPU ranks, against the JAX
package in this process.

The model is the reference's ``tests/test_compression.py`` template
(l.278-290), ``mean((tanh(x w1) @ w2)^2) + mean(b^2)`` with w2 32 x 16
(the one leaf eligible at min_elements=256) and w1 and b exact, with
two changes that keep its reduced gradient away from numerical rank 1,
where the second PowerSGD direction is float32 noise and no two
libraries agree on it: seeded random weights, and each input a row of
32 values (``tanh(x * w1)``) instead of a scalar. Each rank takes its
own 4 rows per step; rank 2 compression, 512-byte
buckets, AdamW (optax.adamw's settings), 3 steps, every side starting
from the reference's warm-start Q (``init_q`` of leaf 2) and zero
residuals.

- The train step (``build_train_step(mesh=..., compression=
  "powersgd:2")``) against the reference's ``build_train_step(
  compression="powersgd:2", overlap=True)`` on a ("data",) mesh of n CPU
  devices fed the concatenated inputs: the plan digest bitwise, the
  parameters, Q and this rank's residual (rows [r n, (r + 1) n) of the
  reference's) within 1e-5 after every step.
- ``DistributedOptimizer(compression=Compression.powersgd(rank=2,
  min_elements=256))`` on the negotiated engine against the reference's
  ``powersgd_reduce`` under ``jax.vmap(..., axis_name="r")`` (the
  reference's eager plane cannot run here: its multi-process collectives
  need a jaxlib that has them) composed with the mean of the exact
  leaves and ``optax.adamw``: the same measures.
- Ranks bitwise equal after every step; ``hvd_wire_bytes_total``'s
  delta per step equal to the plan's accounting.
- World of 2: a step whose gradient rank 1 poisons through the
  ``numerics.grad`` seam is skipped on both ranks, with Q and e bitwise
  unchanged, on both planes, and so is a step where rank 1 poisons only
  the exact leaf b (the step's veto, not w2's bucket's own vote, keeps
  Q and e); a warm-up step (HOROVOD_COMPRESSION_
  WARMUP_STEPS semantics, ``warmup_steps=1``) is bitwise the
  uncompressed optimizer's step and leaves Q and e as they were.

Tolerance 1e-5 relative (Frobenius norm of the error over that of the
reference, per tensor): float32 products, Cholesky and AdamW in another
library and order. The children import torch, numpy and the port, never
JAX.
"""

import threading

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import numerics as tnum
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import train as ttrain
from test_torch_port_distributed import spawn_world

LR, STEPS, RANK, MIN_EL, THRESHOLD, PER_RANK = 1e-2, 3, 2, 256, 512, 4
TAG = f"powersgd:{RANK}"
TOL = 1e-5
LOWRANK = "2"           # w2's leaf index: the tree order is b, w1, w2


def _params():
    rs = np.random.RandomState(0)
    return {"b": (0.1 * rs.randn(3)).astype(np.float32),
            "w1": rs.randn(32).astype(np.float32),
            "w2": (0.3 * rs.randn(32, 16)).astype(np.float32)}


def _x(rank, step):
    return np.random.RandomState(100 * step + rank).randn(
        PER_RANK, 32).astype(np.float32)


# ---------------------------------------------------------------------------
# Children (module-level, so spawn finds them by name)

class _Small(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k in ("b", "w1", "w2"):             # the reference's order
            setattr(self, k, torch.nn.Parameter(
                torch.from_numpy(params[k].copy())))


def _loss(m, batch):
    h = torch.tanh(batch["x"] * m.w1[None, :])
    return torch.mean((h @ m.w2) ** 2) + torch.mean(m.b ** 2) * \
        batch["b_scale"]


def _batch(rank, step, b_scale=1.0):
    """Rank ``rank``'s rows of ``step``; ``b_scale`` multiplies only the
    exact leaf b's term (NaN poisons b's gradient alone)."""
    return {"x": torch.from_numpy(_x(rank, step)),
            "b_scale": torch.tensor(b_scale)}


def _wire():
    return tmetrics.snapshot().get("hvd_wire_bytes_total", {}).get(
        (TAG,), 0.0)


def _np(t):
    return t.detach().numpy().copy()


def _snap(model, state):
    return {"params": {n: _np(p) for n, p in model.named_parameters()},
            "q": _np(state["q"][LOWRANK]), "e": _np(state["e"][LOWRANK]),
            "digest": tnum.params_digest(model)}


def _start(args):
    return {"q": {LOWRANK: torch.from_numpy(args["q0"].copy())},
            "e": {LOWRANK: torch.zeros(32, 16)}}


def _poisoned(rank, fn):
    """``fn()`` with rank 1's numerics.grad seam armed for its first
    hit, so one element of rank 1's first reduced gradient is NaN."""
    if rank == 1:
        tfaults.configure("numerics.grad:nan:at=1")
    try:
        return fn()
    finally:
        tfaults.configure(None)


def _b_poisoned(rank, step):
    return _batch(rank, step, float("nan") if rank == 1 else 1.0)


def _train_plane(rank, size, args):
    model = _Small(args["params"])
    opt = tnum.guard_non_finite(ttrain.adamw(model.parameters(), LR))
    step = ttrain.build_train_step(
        _loss, opt, "cpu", mesh=tmesh.data_parallel_mesh(), overlap=True,
        overlap_threshold=THRESHOLD, compression=TAG,
        compression_min_elements=MIN_EL)
    step.set_compression_state(_start(args))
    out = {"steps": [], "wire": []}
    for s in range(STEPS):
        w0 = _wire()
        step(model, _batch(rank, s))
        out["wire"].append(_wire() - w0)
        out["steps"].append(_snap(model, step.compression_state()))
    out["info"] = ttrain.last_overlap_info()
    if tnum.guard_enabled():
        before = _snap(model, step.compression_state())
        _poisoned(rank, lambda: step(model, _batch(rank, STEPS)))
        after = _snap(model, step.compression_state())
        out["nan"] = {
            "kept": all(before[k].tobytes() == after[k].tobytes()
                        for k in ("q", "e")),
            "params_kept": before["digest"] == after["digest"],
            "skips": opt.total_skips}
        step(model, _batch(rank, STEPS + 1))
        out["nan"]["applied_after"] = \
            _snap(model, step.compression_state())["digest"] != \
            after["digest"]
        # Rank 1 poisons the exact bucket alone: w2's bucket votes
        # clean, the step's veto still keeps its Q and e.
        before = _snap(model, step.compression_state())
        step(model, _b_poisoned(rank, STEPS + 2))
        after = _snap(model, step.compression_state())
        out["nan"]["other_bucket_kept"] = before["digest"] == \
            after["digest"] and all(before[k].tobytes() ==
                                    after[k].tobytes() for k in ("q", "e"))
    return out


def _optimizer(model, compression):
    return hvd.DistributedOptimizer(
        tnum.guard_non_finite(ttrain.adamw(model.parameters(), LR)),
        named_parameters=model.named_parameters(), compression=compression)


def _opt_step(model, opt, rank, s):
    opt.zero_grad()
    _loss(model, _batch(rank, s)).backward()
    opt.step()


def _opt_plane(rank, size, args):
    model = _Small(args["params"])
    opt = _optimizer(model, hvd.Compression.powersgd(
        rank=RANK, min_elements=MIN_EL))
    opt.set_compression_state(_start(args))
    out = {"steps": [], "wire": []}
    for s in range(STEPS):
        w0 = _wire()
        _opt_step(model, opt, rank, s)
        out["wire"].append(_wire() - w0)
        out["steps"].append(_snap(model, opt.compression_state()))
    if tnum.guard_enabled():
        before = _snap(model, opt.compression_state())
        _poisoned(rank, lambda: _opt_step(model, opt, rank, STEPS))
        after = _snap(model, opt.compression_state())
        out["nan"] = {
            "kept": all(before[k].tobytes() == after[k].tobytes()
                        for k in ("q", "e")),
            "params_kept": before["digest"] == after["digest"],
            "skips": opt.total_skips}
        _opt_step(model, opt, rank, STEPS + 1)
        out["nan"]["applied_after"] = \
            _snap(model, opt.compression_state())["digest"] != \
            after["digest"]
        before = _snap(model, opt.compression_state())
        opt.zero_grad()
        _loss(model, _b_poisoned(rank, STEPS + 2)).backward()
        opt.step()
        after = _snap(model, opt.compression_state())
        out["nan"]["other_bucket_kept"] = before["digest"] == \
            after["digest"] and all(before[k].tobytes() ==
                                    after[k].tobytes() for k in ("q", "e"))
        # Warm-up: one exact step (bitwise the uncompressed optimizer's,
        # Q and e untouched), then a compressed one.
        warm_model, plain_model = _Small(args["params"]), \
            _Small(args["params"])
        warm = _optimizer(warm_model, hvd.Compression.powersgd(
            rank=RANK, min_elements=MIN_EL, warmup_steps=1))
        warm.set_compression_state(_start(args))
        plain = _optimizer(plain_model, hvd.Compression.none)
        w0 = _wire()
        _opt_step(warm_model, warm, rank, 0)
        _opt_step(plain_model, plain, rank, 0)
        st = warm.compression_state()
        out["warm"] = {
            "exact": tnum.params_digest(warm_model)
            == tnum.params_digest(plain_model),
            "state_kept": torch.equal(st["q"][LOWRANK],
                                      torch.from_numpy(args["q0"]))
            and not st["e"][LOWRANK].any(),
            "wire": _wire() - w0, "step": st["step"]}
        _opt_step(warm_model, warm, rank, 1)
        _opt_step(plain_model, plain, rank, 1)
        out["warm"]["compressed_after"] = \
            tnum.params_digest(warm_model) != tnum.params_digest(plain_model)
    return out


def job_powersgd(rank, size, args):
    torch.set_num_threads(1)
    return {"train": _train_plane(rank, size, args),
            "opt": _opt_plane(rank, size, args),
            "guard": tnum.guard_enabled()}


# ---------------------------------------------------------------------------
# The reference, in this process

def _jloss(params, x):
    import jax.numpy as jnp
    h = jnp.tanh(x * params["w1"][None, :])
    return jnp.mean((h @ params["w2"]) ** 2) + jnp.mean(params["b"] ** 2)


def _jmesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), axis_names=("data",))


def _snap_ref(params, q, e_rows):
    return {"params": {k: np.asarray(v, np.float32)
                       for k, v in params.items()},
            "q": np.asarray(q, np.float32), "e": np.asarray(e_rows)}


def _reference_train(n):
    """The reference's jitted PowerSGD step on a ("data",) mesh of n
    devices: per step the parameters, Q and every rank's residual."""
    import importlib
    import jax.numpy as jnp
    import optax
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    tx = optax.adamw(LR)
    opt_state = tx.init(params)
    step = jtrain.build_train_step(
        _jloss, tx, _jmesh(n), donate=False, overlap=True,
        overlap_threshold=THRESHOLD, compression=TAG,
        compression_min_elements=MIN_EL)
    cstate, _ = jtrain.init_compression_state(
        params, _jmesh(n), compression=TAG, compression_min_elements=MIN_EL,
        overlap_threshold=THRESHOLD)
    out = []
    for s in range(STEPS):
        x = jnp.asarray(np.concatenate([_x(r, s) for r in range(n)]))
        params, opt_state, _, cstate = step(params, opt_state, x, cstate)
        e = np.asarray(cstate["e"][LOWRANK])
        out.append(_snap_ref(params, cstate["q"][LOWRANK],
                             [e[r * 32:(r + 1) * 32] for r in range(n)]))
    return out


def _reference_eager(n, q0):
    """The reference's eager PowerSGD round, ``powersgd_reduce`` under
    vmap over n ranks, composed with the mean of the exact leaves and
    optax.adamw."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from horovod_tpu.ops import compression as jc
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    tx = optax.adamw(LR)
    opt_state = tx.init(params)
    q = jnp.asarray(q0)
    es = jnp.zeros((n, 32, 16), jnp.float32)
    grad = jax.grad(_jloss)

    def round_(ms, e):
        outs, qs, new_es = jc.powersgd_reduce(
            [ms], [q], [e], lambda f: lax.psum(f, "r"), n)
        return outs[0], qs[0], new_es[0]

    out = []
    for s in range(STEPS):
        gs = [grad(params, jnp.asarray(_x(r, s))) for r in range(n)]
        red = {}
        for k in ("b", "w1"):
            total = gs[0][k]
            for g in gs[1:]:
                total = total + g[k]
            red[k] = total / jnp.float32(n)
        outs, qs, es = jax.vmap(round_, axis_name="r")(
            jnp.stack([g["w2"] for g in gs]), es)
        red["w2"] = outs[0] * jnp.float32(1.0 / n)
        q = qs[0]
        updates, opt_state = tx.update(red, opt_state, params)
        params = optax.apply_updates(params, updates)
        out.append(_snap_ref(params, q, [es[r] for r in range(n)]))
    return out


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


@pytest.fixture(scope="module")
def q0():
    """The reference's warm start for w2 (leaf 2), which every side
    starts from."""
    from horovod_tpu.ops import compression as jc
    return np.array(jc.init_q((32, 16), RANK, 2), np.float32)


@pytest.fixture(scope="module")
def runs(q0, tmp_path_factory):
    """{size: the ranks' results} for the worlds of 2 and 3, spawned from
    threads while this process computes the references:
    {("train" | "opt", size): per-step snapshots}."""
    results = {}
    stores = {n: tmp_path_factory.mktemp(f"psgd{n}") for n in (2, 3)}

    def run(size):
        try:
            results[size] = spawn_world(
                size, job_powersgd, stores[size], timeout=120,
                params=_params(), q0=q0,
                overrides={"HOROVOD_NUMERICS_GUARD": size == 2})
        except BaseException as e:  # noqa: BLE001 — raised below
            results[size] = e

    threads = [threading.Thread(target=run, args=(n,)) for n in (2, 3)]
    for t in threads:
        t.start()
    try:
        refs = {}
        for n in (2, 3):
            refs[("train", n)] = _reference_train(n)
            refs[("opt", n)] = _reference_eager(n, q0)
    finally:
        for t in threads:
            t.join(timeout=300)
    for n in (2, 3):
        if isinstance(results.get(n), BaseException):
            raise results[n]
    return results, refs


@pytest.mark.parametrize("plane", ["train", "opt"])
@pytest.mark.parametrize("size", [2, 3])
def test_steps_match_the_reference(runs, size, plane):
    results, refs = runs
    for rank, o in enumerate(results[size]):
        assert o["guard"] == (size == 2)
        for s, want in enumerate(refs[(plane, size)]):
            got = o[plane]["steps"][s]
            for k, v in want["params"].items():
                assert _rel(got["params"][k], v) <= TOL, (s, k)
            assert _rel(got["q"], want["q"]) <= TOL, s
            assert _rel(got["e"], want["e"][rank]) <= TOL, (s, rank)


@pytest.mark.parametrize("plane", ["train", "opt"])
@pytest.mark.parametrize("size", [2, 3])
def test_ranks_are_bitwise_equal(runs, size, plane):
    outs = runs[0][size]
    for s in range(STEPS):
        assert len({o[plane]["steps"][s]["digest"] for o in outs}) == 1
        assert len({o[plane]["steps"][s]["q"].tobytes() for o in outs}) == 1


@pytest.mark.parametrize("size", [2, 3])
def test_plan_digest_is_the_references(runs, size):
    import importlib
    import jax.numpy as jnp
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    want = jtrain.plan_overlap(params, _jmesh(size),
                               overlap_threshold=THRESHOLD,
                               guard=size == 2, compression=TAG,
                               compression_min_elements=MIN_EL)
    assert want.digest == f"2:2048|c={TAG};1,0:140"
    for o in runs[0][size]:
        info = o["train"]["info"]
        assert info["digest"] == want.digest
        assert info["compression"] == TAG
        wire = sum(g.n * 4 for groups in want.wire for g in groups)
        assert info["wire_bucket_bytes"] == wire
        assert info["raw_bucket_bytes"] == sum(want.bucket_nbytes)


@pytest.mark.parametrize("size", [2, 3])
def test_wire_bytes_delta_is_the_plans(runs, size):
    """Per step: the train step moves its plan's wire (both factor
    allreduces, (32 + 16) x 2 float32, and the exact bucket of w1 and b,
    with the flag riding it under the guard); the optimizer records the
    factor bytes of its round."""
    factors = 4 * (32 + 16) * RANK
    exact = 4 * (32 + 3 + (1 if size == 2 else 0))
    for o in runs[0][size]:
        assert o["train"]["wire"] == [factors + exact] * STEPS
        assert o["opt"]["wire"] == [factors] * STEPS


@pytest.mark.parametrize("plane", ["train", "opt"])
def test_a_poisoned_step_freezes_q_and_e_on_every_rank(runs, plane):
    for o in runs[0][2]:
        r = o[plane]["nan"]
        assert r["kept"] and r["params_kept"], r
        assert r["skips"] == 1 and r["applied_after"], r
        assert r["other_bucket_kept"], r


def test_warmup_step_is_exact(runs):
    for o in runs[0][2]:
        w = o["opt"]["warm"]
        assert w["exact"] and w["state_kept"] and w["wire"] == 0, w
        assert w["step"] == 1 and w["compressed_after"], w


@pytest.mark.parametrize("size", [2, 3])
def test_ranks_load_no_jax(runs, size):
    assert [o["loaded"] for o in runs[0][size]] == [[]] * size
