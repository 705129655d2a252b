"""PowerSGD, its registry, the loss scaler and the numerics chaos seams
of the port (``horovod_tpu_torch/ops/compression.py``,
``parallel/train.py``, ``optim/distributed_optimizer.py``,
``numerics.py``) against the JAX package's, in one process.

Tolerances. ``gram_orthogonalize``: 1e-5 absolute on an orthonormal
result (float32 Cholesky and triangular solve in another library).
``powersgd_reduce``: 1e-5 relative per output (Frobenius norm of the
error over that of the reference's output), float32 products in
another order. Shapes, plans, registry values and the loss scaler's
states: exact (bitwise for the scales). The seams: bitwise.

The n ranks of ``powersgd_reduce`` are threads sharing a summing wire
(every rank adds the slots in rank order, so all get the same sum); the
reference runs under ``jax.vmap(..., axis_name="r")`` with ``lax.psum``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import horovod_tpu_torch as hvd
from horovod_tpu.ops import compression as jc
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import numerics as tnum
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.ops import compression as tc
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import train as ttrain

TOL = 1e-5
KNOBS = ("HOROVOD_COMPRESSION", "HOROVOD_COMPRESSION_RANK",
         "HOROVOD_COMPRESSION_WARMUP_STEPS",
         "HOROVOD_COMPRESSION_MIN_ELEMENTS")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# The registry

@pytest.mark.parametrize("raw", [
    "none", "fp16", "bf16", "powersgd", "powersgd:2", "powersgd(rank=8)",
    "powersgd(3)", "POWERSGD:1", "  Powersgd:4 "])
def test_accepted_spellings(raw):
    assert tc.resolve_compression(raw) == jc.resolve_compression(raw)


@pytest.mark.parametrize("raw,match", [
    ("powersdg", "unknown"), ("powersgdx", "unparseable"),
    ("powersgd:0", "rank"), ("fp32", "unknown"), ("powersgd:-2", "rank")])
def test_typos_raise(raw, match):
    for mod in (tc, jc):
        with pytest.raises(ValueError, match=match):
            mod.resolve_compression(raw)


@pytest.mark.parametrize("env", [
    {}, {"HOROVOD_COMPRESSION": "powersgd"},
    {"HOROVOD_COMPRESSION": "powersgd", "HOROVOD_COMPRESSION_RANK": "8",
     "HOROVOD_COMPRESSION_MIN_ELEMENTS": "100",
     "HOROVOD_COMPRESSION_WARMUP_STEPS": "3"},
    {"HOROVOD_COMPRESSION": "powersgd:2",
     "HOROVOD_COMPRESSION_RANK": "8"},
    {"HOROVOD_COMPRESSION": "bf16"}])
def test_knobs_resolve_as_the_references(monkeypatch, env):
    """The knob family with and without overrides, through the registry
    and through the train step's builder read."""
    import importlib
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tc.resolve_compression() == jc.resolve_compression()
    assert ttrain.compression_spec() == jtrain.compression_spec()
    assert ttrain.compression_spec(rank=5, min_elements=7) == \
        jtrain.compression_spec(rank=5, min_elements=7)
    assert tc.PowerSGD().spec == jc.PowerSGD().spec
    if not env:
        assert tc.resolve_compression() == ("none", 4, 4096, 0)


@pytest.mark.parametrize("raw", ["none", "fp16", "bf16", "powersgd:3",
                                 "powersgd"])
def test_tags(raw):
    assert tc.resolve_compression(raw).tag() == \
        jc.resolve_compression(raw).tag()
    assert tc.PowerSGD(rank=3).spec.tag() == "powersgd:3"
    assert not hasattr(tc.Compression.powersgd(), "wire_dtype")


@pytest.mark.parametrize("which", ["none", "str", "classes", "powersgd",
                                   "spec"])
def test_spec_of(which):
    if which == "none":
        pairs = [(None, None)]
    elif which == "str":
        pairs = [("powersgd:2", "powersgd:2"), ("bf16", "bf16")]
    elif which == "classes":
        pairs = [(tc.Compression.none, jc.Compression.none),
                 (tc.Compression.fp16, jc.Compression.fp16),
                 (tc.Compression.bf16, jc.Compression.bf16)]
    elif which == "powersgd":
        pairs = [(tc.PowerSGD(rank=3, min_elements=10, warmup_steps=2),
                  jc.PowerSGD(rank=3, min_elements=10, warmup_steps=2))]
    else:
        pairs = [(tc.CompressionSpec("powersgd", 2, 5, 1),
                  jc.CompressionSpec("powersgd", 2, 5, 1))]
    for t, j in pairs:
        assert tuple(tc.spec_of(t)) == tuple(jc.spec_of(j))
    with pytest.raises(ValueError, match="unrecognized"):
        tc.spec_of(42)


# ---------------------------------------------------------------------------
# Shapes, eligibility and wire accounting

SHAPES = [(2, 2), (1, 5), (5, 1), (2, 1), (32, 16), (4096, 4096),
          (4096, 11008), (11008, 4096), (32000, 4096), (24, 64, 64),
          (2, 4096, 11008), (2, 11008, 4096), (2, 3, 4, 5), (7, 1, 1),
          (1, 1, 9), (64, 2), (3, 1000)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_shapes_eligibility_and_wire(shape):
    assert tc.matrix_shape(shape) == jc.matrix_shape(shape)
    for r in (1, 2, 4, 8, 100):
        assert tc.effective_rank(shape, r) == jc.effective_rank(shape, r)
        assert tc.powersgd_wire_elements(shape, r) == \
            jc.powersgd_wire_elements(shape, r)
    for dt in ("float32", "bfloat16", "float16", "int32"):
        for me in (0, 4, 256, 4096, 1 << 30):
            assert tc.powersgd_eligible(shape, getattr(torch, dt), me) == \
                jc.powersgd_eligible(shape, getattr(jnp, dt), me), (dt, me)


@pytest.mark.parametrize("shape", [(), (3,), (4096,)], ids=str)
def test_vectors_are_never_eligible(shape):
    for me in (0, 1):
        assert not tc.powersgd_eligible(shape, torch.float32, me)
        assert not jc.powersgd_eligible(shape, jnp.float32, me)


# ---------------------------------------------------------------------------
# The math

def _orth_cases():
    rs = np.random.RandomState(3)
    dup = rs.randn(64, 3).astype(np.float32)
    dup[:, 2] = dup[:, 0]
    return {"random": rs.randn(50, 4).astype(np.float32),
            "tall": rs.randn(4096, 4).astype(np.float32),
            "zero": np.zeros((8, 3), np.float32),
            "duplicate_column": dup,
            "one_column": rs.randn(10, 1).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_orth_cases()))
def test_gram_orthogonalize(case):
    p = _orth_cases()[case]
    got = tc.gram_orthogonalize(torch.from_numpy(p)).numpy()
    want = np.asarray(jc.gram_orthogonalize(jnp.asarray(p)))
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if case in ("random", "tall"):
        np.testing.assert_allclose(got.T @ got, np.eye(p.shape[1]),
                                   atol=1e-5)


def test_init_q_is_orthonormal_and_the_same_everywhere():
    """The port's own warm start (a declared difference from the
    reference's threefry draw): orthonormal, a function of the leaf
    index alone, and bitwise the same on every call."""
    a = tc.init_q((24, 64, 64), 4, 7, "cpu")
    assert a.shape == (64, 4) and a.dtype == torch.float32
    assert torch.equal(a, tc.init_q((24, 64, 64), 4, 7, "cpu"))
    assert not torch.equal(a, tc.init_q((24, 64, 64), 4, 8, "cpu"))
    np.testing.assert_allclose((a.T @ a).numpy(), np.eye(4), atol=1e-5)
    assert tc.init_q((2, 3), 4, 0, "cpu").shape == (3, 2)


class _SimPsum:
    """n threads summing one flat tensor each, in rank order."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def fn(self, rank):
        def psum(flat):
            self.slots[rank] = flat
            self.barrier.wait()
            total = self.slots[0].clone()
            for x in self.slots[1:]:
                total = total + x
            self.barrier.wait()
            return total
        return psum


def _port_round(mats, qs, es, n):
    """Every rank's ``powersgd_reduce`` result, ranks as threads."""
    wire = _SimPsum(n)
    out = [None] * n

    def run(r):
        out[r] = tc.powersgd_reduce(
            [torch.from_numpy(m[r]) for m in mats],
            [torch.from_numpy(q) for q in qs],
            [torch.from_numpy(e[r]) for e in es], wire.fn(r), n)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


def _ref_round(mats, qs, es, n, dtype=jnp.float32):
    def one(ms, es_):
        return jc.powersgd_reduce(
            list(ms), [jnp.asarray(q) for q in qs], list(es_),
            lambda x: lax.psum(x, "r"), n)
    return jax.vmap(one, axis_name="r")(
        [jnp.asarray(m, dtype) for m in mats], [jnp.asarray(e) for e in es])


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_powersgd_reduce_matches_the_reference(n):
    rs = np.random.RandomState(10 + n)
    shapes = [(32, 16), (20, 30), (64, 2)]
    ranks = [2, 4, 1]
    mats = [rs.randn(n, *s).astype(np.float32) for s in shapes]
    qs = [np.array(jc.gram_orthogonalize(jnp.asarray(
        rs.randn(s[1], r).astype(np.float32)))) for s, r in
        zip(shapes, ranks)]
    es = [(0.1 * rs.randn(n, *s)).astype(np.float32) for s in shapes]
    port = _port_round(mats, qs, es, n)
    outs, new_qs, new_es = _ref_round(mats, qs, es, n)
    for r in range(n):
        for i in range(len(shapes)):
            for got, want in ((port[r][0][i], outs[i][r]),
                              (port[r][1][i], new_qs[i][r]),
                              (port[r][2][i], new_es[i][r])):
                assert got.dtype == torch.float32
                assert _rel(got.numpy(), want) <= TOL
        for i in range(len(shapes)):     # every rank decodes the same
            assert torch.equal(port[r][0][i], port[0][0][i])
            assert torch.equal(port[r][1][i], port[0][1][i])


def test_powersgd_reduce_of_bf16_matrices():
    """bf16 gradients go in as their float32 values on both sides."""
    n, shape = 2, (48, 24)
    rs = np.random.RandomState(5)
    raw = torch.from_numpy(rs.randn(n, *shape).astype(np.float32)).to(
        torch.bfloat16)
    mats32 = [raw.float().numpy()]
    q = [np.array(jc.gram_orthogonalize(jnp.asarray(
        rs.randn(shape[1], 4).astype(np.float32))))]
    es = [np.zeros((n, *shape), np.float32)]
    wire = _SimPsum(n)
    got = [None] * n

    def run(r):
        got[r] = tc.powersgd_reduce([raw[r]], [torch.from_numpy(q[0])],
                                    [torch.from_numpy(es[0][r])],
                                    wire.fn(r), n)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    outs, _, new_es = _ref_round(mats32, q, es, n, jnp.bfloat16)
    for r in range(n):
        assert _rel(got[r][0][0].numpy(), outs[0][r]) <= TOL
        assert _rel(got[r][2][0].numpy(), new_es[0][r]) <= TOL


def test_full_rank_round_is_the_exact_sum():
    """At r = min(n, m) the round reproduces the sum over ranks (the
    reference's exactness property) and leaves no residual."""
    n, shape = 3, (6, 4)
    rs = np.random.RandomState(9)
    mats = [rs.randn(n, *shape).astype(np.float32)]
    q = [np.array(jc.gram_orthogonalize(jnp.asarray(
        rs.randn(shape[1], 4).astype(np.float32))))]
    es = [np.zeros((n, *shape), np.float32)]
    port = _port_round(mats, q, es, n)
    want = mats[0].sum(0)
    for r in range(n):
        np.testing.assert_allclose(port[r][0][0].numpy(), want, atol=1e-4)


# ---------------------------------------------------------------------------
# The plan and the state

def _tree(seed):
    """Leaves on both sides: matrices (2-D and stacked 3-D) of three
    float dtypes, vectors, a scalar and an integer leaf."""
    rs = np.random.RandomState(seed)
    spec = {"a_emb": ((64, 32), "float32"), "b_norm": ((32,), "float32"),
            "c_w": ((3, 32, 48), "bfloat16"), "d_b": ((48,), "float16"),
            "e_w": ((48, 32), "float16"), "f_s": ((), "float32"),
            "g_i": ((5,), "int32"), "h_w": ((16, 16), "float32"),
            "i_w": ((2, 2), "float32")}
    ttree, jtree = {}, {}
    for k, (shape, dt) in spec.items():
        x = np.asarray(rs.randn(*shape), np.float32)
        ttree[k] = torch.from_numpy(x).to(getattr(torch, dt))
        jtree[k] = jnp.asarray(x, getattr(jnp, dt))
    return ttree, jtree


def _jmesh(n):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), axis_names=("data",))


@pytest.mark.parametrize("comp", ["powersgd", "powersgd:2",
                                  "powersgd(rank=8)"])
@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("threshold", [64, 2000, 1 << 20])
def test_plan_overlap_under_powersgd(threshold, guard, comp):
    import importlib
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    ttree, jtree = _tree(1)
    for n in (1, 2, 3):
        for me in (0, 256, 4096):
            got = ttrain.plan_overlap(
                ttree, tmesh.Mesh({"data": n}), overlap_threshold=threshold,
                guard=guard, compression=comp, compression_min_elements=me)
            want = jtrain.plan_overlap(
                jtree, _jmesh(n), overlap_threshold=threshold, guard=guard,
                compression=comp, compression_min_elements=me)
            assert tuple(got) == tuple(want), (n, me)


def test_init_compression_state_against_the_references():
    """Same keys; Q of the same shape; this rank's residual (n, m) where
    the reference's global one stacks every rank's, (n_ranks n, m)."""
    import importlib
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    ttree, jtree = _tree(2)
    for n in (2, 3):
        got = ttrain.init_compression_state(
            ttree, tmesh.Mesh({"data": n}), compression="powersgd:2",
            compression_min_elements=256, overlap_threshold=2000)
        want, _ = jtrain.init_compression_state(
            jtree, _jmesh(n), compression="powersgd:2",
            compression_min_elements=256, overlap_threshold=2000)
        assert sorted(got["q"]) == sorted(want["q"]) == \
            sorted(got["e"]) == ["0", "2", "4", "7"]
        for k in want["q"]:
            assert tuple(got["q"][k].shape) == want["q"][k].shape
            en, em = want["e"][k].shape
            assert tuple(got["e"][k].shape) == (en // n, em)
            assert not got["e"][k].any()
            assert got["q"][k].dtype == got["e"][k].dtype == torch.float32


LLAMA2_7B_2 = dict(vocab=32000, d_model=4096, n_layers=2, n_heads=32,
                   n_kv_heads=32, head_dim=128, d_ff=11008, max_seq=2048)
# The flagship (Llama-2-7B width, 2 layers) under powersgd:4 at the
# default 64 MiB: each matrix compressed in its stored (out, in) layout,
# the five float32 norms in one exact bucket (chip_smoke.py's
# PSGD_PLAN).
FLAGSHIP_PSGD_DIGEST = (
    "19:90177536|c=powersgd:4;18:90177536|c=powersgd:4;"
    "17:90177536|c=powersgd:4;16,15:67108864|c=powersgd:4;"
    "14,13:67108864|c=powersgd:4;12,11,3,2,1:81920;"
    "10:90177536|c=powersgd:4;9:90177536|c=powersgd:4;"
    "8:90177536|c=powersgd:4;7,6:67108864|c=powersgd:4;"
    "5,4:67108864|c=powersgd:4;0:262144000|c=powersgd:4")


def test_flagship_plan_under_powersgd_at_full_width():
    """Every matrix compressed, tagged powersgd:4; the wire is
    (n + m) r float32 elements per matrix, plus the norms (and the
    flag riding them): 769,024 factor elements."""
    model = ttfm.Transformer(ttfm.TransformerConfig(**LLAMA2_7B_2),
                             torch.device("meta"))
    plan = ttrain.plan_overlap(model, tmesh.Mesh({"data": 2}),
                               overlap_threshold=64 << 20, guard=True,
                               compression="powersgd:4")
    assert plan.digest == FLAGSHIP_PSGD_DIGEST
    tags = plan.bucket_compression
    assert tags.count("none") == 1 and len(tags) == 12
    factors = sum(g.n for w, t in zip(plan.wire, tags) if t != "none"
                  for g in w)
    assert factors == 769_024 == sum(
        sum(tc.powersgd_wire_elements(tuple(p.shape), 4))
        for p in model.parameters() if p.dim() == 2)
    assert ttrain._wire_bytes(plan) == 4 * 769_024 + 4 * (5 * 4096 + 1)


def test_plan_of_the_flagship_in_the_jax_layout_under_powersgd():
    """A 2-layer narrow bf16 flagship carried to the JAX layout
    (``params_to_jax``, layers stacked (L, in, out)) plans under
    powersgd as the reference's own tree does: the same digest, tags
    and factor wire."""
    import importlib
    from horovod_tpu import weights as jweights
    from horovod_tpu.models import transformer as jtfm
    jtrain = importlib.import_module("horovod_tpu.parallel.train")
    kw = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
              head_dim=32, d_ff=256, max_seq=64)
    tcfg = ttfm.TransformerConfig(**kw)
    model = ttfm.init_params(tcfg, seed=0, device="cpu")
    named = ttfm.params_to_jax(tcfg, model)
    jcfg = jtfm.TransformerConfig(**kw, dtype=jnp.bfloat16, tp_axis=None,
                                  sp_axis=None, ep_axis=None)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jdtypes = {n: str(a.dtype) for n, a in jweights.named_leaves(jparams)}
    ttree = {"layers": {}}
    for key, arr in named.items():
        t = torch.from_numpy(arr).to(getattr(torch, jdtypes[key]))
        parts = [p.strip("'") for p in key.strip("[]").split("][")]
        if parts[0] == "layers":
            ttree["layers"][parts[1]] = t
        else:
            ttree[parts[0]] = t
    for threshold in (1 << 16, 1 << 20, 64 << 20):
        for guard in (False, True):
            got = ttrain.plan_overlap(ttree, tmesh.Mesh({"data": 2}),
                                      overlap_threshold=threshold,
                                      guard=guard, compression="powersgd:4",
                                      compression_min_elements=1024)
            want = jtrain.plan_overlap(jparams, _jmesh(2),
                                       overlap_threshold=threshold,
                                       guard=guard, compression="powersgd:4",
                                       compression_min_elements=1024)
            assert tuple(got) == tuple(want)
            assert "powersgd:4" in got.bucket_compression


class _Small(torch.nn.Module):
    """The reference's ``tests/test_compression.py`` ``_params`` (l.283),
    registered in its tree's order: b, w1, w2 (32 x 16, the one leaf
    eligible at min_elements=256)."""

    def __init__(self):
        super().__init__()
        self.b = torch.nn.Parameter(torch.zeros(3))
        self.w1 = torch.nn.Parameter(torch.arange(32.0) / 32.0)
        self.w2 = torch.nn.Parameter(
            torch.ones(32, 16) * 0.1
            + torch.arange(32.0 * 16).reshape(32, 16) * 1e-3)


def test_train_step_checks_a_set_state():
    """A set state must hold exactly the plan's low-rank leaves at their
    shapes; a mismatch raises at the next step instead of dropping the
    residual. A world of one compresses nothing (no bucket)."""
    model = _Small()
    mesh = tmesh.Mesh({"data": 2})
    step = ttrain.build_train_step(
        lambda m, b: (m.w2 ** 2).sum(), torch.optim.SGD(
            model.parameters(), lr=0.1), "cpu", mesh=mesh, overlap=True,
        overlap_threshold=512, compression="powersgd:2",
        compression_min_elements=256)
    assert step.compression_state() is None
    good = ttrain.init_compression_state(
        model, mesh, compression="powersgd:2", compression_min_elements=256,
        overlap_threshold=512)
    assert sorted(good["q"]) == ["2"]
    step.set_compression_state(good)
    assert step.compression_state()["q"]["2"] is good["q"]["2"]
    bad = {"q": dict(good["q"], **{"1": good["q"]["2"]}), "e": good["e"]}
    step.set_compression_state(bad)
    with pytest.raises(ValueError, match="does not match"):
        step(model, {})
    step.set_compression_state({"q": good["q"],
                                "e": {"2": torch.zeros(16, 32)}})
    with pytest.raises(ValueError, match=r"e\[2\]"):
        step(model, {})
    step.set_compression_state({"q": {"2": torch.zeros(16, 4)},
                                "e": good["e"]})
    with pytest.raises(ValueError, match=r"q\[2\] is \(16, 4\), not "
                                         r"\(16, 2\)"):
        step(model, {})
    assert not hasattr(ttrain.build_train_step(
        lambda m, b: 0, torch.optim.SGD(model.parameters(), lr=0.1), "cpu",
        mesh=mesh), "compression_state")


# ---------------------------------------------------------------------------
# The eager plane in a world of one

@pytest.mark.parametrize("kw,match", [
    ({"op": hvd.Adasum}, "Average/Sum"),
    ({"op": hvd.Min}, "Average/Sum"),
    ({"gradient_predivide_factor": 2.0}, "predivide"),
    ({"backward_passes_per_step": 2}, "backward_passes_per_step")])
def test_optimizer_keeps_the_references_refusals(kw, match):
    hvd.init()
    try:
        model = _Small()
        with pytest.raises(ValueError, match=match):
            hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters(),
                compression=hvd.Compression.powersgd(rank=2,
                                                     min_elements=256),
                **kw)
    finally:
        hvd.shutdown()


def test_optimizer_state_stays_out_of_adamw_and_round_trips():
    """Q and e stay out of ``self.state`` (AdamW still creates its step
    and moments), ride ``state_dict()["powersgd"]`` and come back with
    ``load_state_dict``; the round at one rank is the reference's at
    n = 1 and the wire counter moves by its factor bytes."""
    hvd.init()
    try:
        model = _Small()
        opt = hvd.DistributedOptimizer(
            ttrain.adamw(model.parameters(), 1e-3),
            named_parameters=model.named_parameters(),
            compression=hvd.Compression.powersgd(rank=2, min_elements=256))
        st = opt.compression_state()
        assert sorted(st["q"]) == ["2"] and st["step"] == 0
        q0 = st["q"]["2"].clone()
        rnd = torch.from_numpy(np.random.RandomState(2).randn(32, 16)
                               .astype(np.float32))
        before = tmetrics.snapshot().get("hvd_wire_bytes_total", {}).get(
            ("powersgd:2",), 0.0)
        opt.zero_grad()
        ((model.w2 * rnd).sum() + model.w1.sum()
         + (model.b ** 2).mean()).backward()
        raw = model.w2.grad.clone()
        opt.step()
        after = tmetrics.snapshot()["hvd_wire_bytes_total"][("powersgd:2",)]
        assert after - before == 4 * (32 * 2 + 16 * 2)
        for p in model.parameters():
            assert set(opt.state[p]) == {"step", "exp_avg", "exp_avg_sq"}
        outs, new_qs, new_es = jc.powersgd_reduce(
            [jnp.asarray(raw.numpy())], [jnp.asarray(q0.numpy())],
            [jnp.zeros((32, 16), jnp.float32)], lambda f: f, 1)
        st = opt.compression_state()
        assert st["step"] == 1
        assert _rel(st["q"]["2"].numpy(), new_qs[0]) <= TOL
        assert _rel(st["e"]["2"].numpy(), new_es[0]) <= TOL
        sd = opt.state_dict()
        assert set(sd["powersgd"]) == {"q", "e", "step"}
        fresh = hvd.DistributedOptimizer(
            ttrain.adamw(_Small().parameters(), 1e-3),
            compression=hvd.Compression.powersgd(rank=2, min_elements=256))
        fresh.load_state_dict(sd)
        got = fresh.compression_state()
        assert got["step"] == 1
        assert torch.equal(got["q"]["2"], st["q"]["2"])
        assert torch.equal(got["e"]["2"], st["e"]["2"])
        with pytest.raises(ValueError, match="compresses"):
            fresh.set_compression_state({"q": {}, "e": {}})
        with pytest.raises(ValueError, match=r"want \(16, 2\)"):
            fresh.set_compression_state({"q": {"2": torch.zeros(16, 3)},
                                         "e": st["e"]})
        plain = hvd.DistributedOptimizer(
            torch.optim.SGD(_Small().parameters(), lr=0.1))
        assert plain.compression_state() is None
        assert "powersgd" not in plain.state_dict()
        with pytest.raises(ValueError, match="does not compress"):
            plain.load_state_dict(dict(plain.state_dict(),
                                       powersgd=sd["powersgd"]))
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The loss scaler

FLAGS = ([True] * 7 + [False] + [True] * 2 + [False] * 20 + [True] * 9)


@pytest.mark.parametrize("cfg", [
    dict(init_scale=1024.0, growth_interval=3),
    dict(init_scale=3.0, growth_interval=2, growth_factor=3.0,
         backoff_factor=0.25, min_scale=0.5),
    dict()])
def test_loss_scaler_matches_bitwise(cfg):
    from horovod_tpu import numerics as jnum
    t, j = tnum.DistributedLossScaler(**cfg), jnum.DistributedLossScaler(**cfg)
    ts, js = t.init("cpu"), j.init()
    assert ts.scale.dtype == torch.float32
    assert ts.growth_count.dtype == torch.int32
    for ok in FLAGS:
        ts = t.update(ts, torch.tensor(ok))
        js = j.update(js, jnp.asarray(ok))
        assert ts.scale.numpy().tobytes() == \
            np.asarray(js.scale, np.float32).tobytes()
        assert int(ts.growth_count) == int(js.growth_count)
    assert tmetrics.snapshot()["hvd_loss_scale"][()] == float(ts.scale)
    a = np.random.RandomState(8).randn(7).astype(np.float32)
    g = {"a": torch.from_numpy(a),
         "b": [torch.ones(2, 3, dtype=torch.bfloat16)]}
    jg = {"a": jnp.asarray(a), "b": [jnp.ones((2, 3), jnp.bfloat16)]}
    got, want = t.unscale(g, ts), j.unscale(jg, js)
    assert got["a"].numpy().tobytes() == np.asarray(want["a"]).tobytes()
    assert got["b"][0].dtype == torch.bfloat16
    assert got["b"][0].float().numpy().tobytes() == \
        np.asarray(want["b"][0], np.float32).tobytes()
    loss = torch.tensor(0.75)
    assert float(t.scale(loss, ts)) == float(j.scale(jnp.float32(0.75), js))


def test_loss_scaler_knobs_and_refusals(monkeypatch):
    monkeypatch.setenv("HOROVOD_NUMERICS_INIT_SCALE", "256")
    monkeypatch.setenv("HOROVOD_NUMERICS_GROWTH_INTERVAL", "5")
    s = tnum.DistributedLossScaler()
    assert (s.init_scale, s.growth_interval) == (256.0, 5)
    for bad in (dict(growth_factor=1.0), dict(backoff_factor=1.0)):
        with pytest.raises(ValueError, match="growth_factor"):
            tnum.DistributedLossScaler(**bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        s.init()


# ---------------------------------------------------------------------------
# The chaos seams

@pytest.fixture
def armed():
    from horovod_tpu import faults as jfaults

    def arm(spec):
        tfaults.configure(spec, 0)
        jfaults.configure(spec, 0)
    yield arm
    tfaults.configure(None)
    jfaults.configure(None)


@pytest.mark.parametrize("act", ["nan", "inf"])
def test_corrupt_grads_seam(armed, act):
    from horovod_tpu import numerics as jnum
    rs = np.random.RandomState(4)
    ints = rs.randint(0, 9, (4,)).astype(np.int32)
    a = rs.randn(3, 5).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    tl = [torch.from_numpy(ints), torch.from_numpy(a), torch.from_numpy(b)]
    assert tnum.maybe_corrupt_grads(tl) is tl          # disarmed
    armed(f"numerics.grad:{act}:at=2")
    jl = [jnp.asarray(ints), jnp.asarray(a), jnp.asarray(b)]
    assert tnum.maybe_corrupt_grads(tl) is tl          # hit 1: no fire
    assert jnum.maybe_corrupt_grads(jl) is jl
    got, want = tnum.maybe_corrupt_grads(tl), jnum.maybe_corrupt_grads(jl)
    assert got is not tl
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    assert np.isfinite(tl[1].numpy()).all()            # input untouched
    assert tnum.maybe_corrupt_grads([torch.arange(3)]) is not None


def test_flip_param_seam(armed):
    from horovod_tpu import numerics as jnum
    rs = np.random.RandomState(6)
    tree = {"b": rs.randn(3, 5).astype(np.float32),
            "a": rs.randint(0, 5, (4,)).astype(np.int32),
            "c": [rs.randn(2).astype(np.float32)]}
    ttree = {"b": torch.from_numpy(tree["b"].copy()),
             "a": torch.from_numpy(tree["a"]),
             "c": [torch.from_numpy(tree["c"][0])]}
    assert tnum.maybe_flip_param(ttree) is ttree       # disarmed
    armed("numerics.param:flip:at=1")
    got = tnum.maybe_flip_param(ttree)
    want = jnum.maybe_flip_param(jax.tree_util.tree_map(jnp.asarray, tree))
    assert got["b"].numpy().tobytes() == np.asarray(want["b"]).tobytes()
    assert got["b"].numpy().tobytes() != tree["b"].tobytes()
    assert torch.equal(got["c"][0], ttree["c"][0])
    assert ttree["b"].numpy().tobytes() == tree["b"].tobytes()
    assert tnum.maybe_flip_param(ttree) is ttree       # fired once
