"""The port's copy of the bucketing layer (``ops/bucketing.py``) and its
bucket plan (``parallel/train.py`` ``plan_overlap``) against the JAX
package's, on the CPU: the same leaves (torch tensors on the port's
side, jax arrays of the same shapes and dtypes on the reference's) give
bitwise the same sizes, partitions, digests and wire groups.

The trees are seeded mixes of float32, float64, float16, bfloat16,
int32, int64, bool and complex64 leaves, scalars among them. The
flagship's plan is pinned twice: on a 2-layer narrow model given in the
JAX layout by ``params_to_jax`` (the reference's stacked tree), and on
the model's own ``named_parameters()`` order against the reference's
``partition_buckets`` over the same shapes and dtypes, at Llama-2-7B
width on the ``meta`` device (no memory) with the digest the card run
gates on.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.ops import bucketing as jb
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.ops import bucketing as tb
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import train as ttrain

jtrain = importlib.import_module("horovod_tpu.parallel.train")

DTYPES = ["float32", "float64", "float16", "bfloat16", "int32", "int64",
          "bool", "complex64"]
# The flagship's plan at Llama-2-7B width, 2 layers, the default 64 MiB.
FLAGSHIP_DIGEST = (
    "19:90177536;18:90177536;17:90177536;16,15:67108864;14,13:67108864;"
    "12,11:32768;10:90177536;9:90177536;8:90177536;7,6:67108864;"
    "5,4:67108864;3,2,1:49152;0:262144000")
LLAMA2_7B_2 = dict(vocab=32000, d_model=4096, n_layers=2, n_heads=32,
                   n_kv_heads=32, head_dim=128, d_ff=11008, max_seq=2048)


def _pair(shape, dtype):
    """The same leaf on both sides: a torch tensor and a jax array."""
    t = torch.zeros(shape, dtype=getattr(torch, dtype))
    return t, jnp.zeros(shape, getattr(jnp, dtype))


def _leaves(seed, n=14):
    rng = np.random.RandomState(seed)
    pairs = []
    for i in range(n):
        shape = () if i % 5 == 0 else tuple(
            int(d) for d in rng.randint(1, 40, size=rng.randint(1, 3)))
        pairs.append(_pair(shape, DTYPES[rng.randint(len(DTYPES))]))
    pairs.append(_pair((3, 5), "bfloat16"))
    pairs.append(_pair((), "float32"))
    return [t for t, _ in pairs], [j for _, j in pairs]


SEEDS = [0, 1, 2]
THRESHOLDS = [0, 1, 64, 700, 1 << 20]


@pytest.mark.parametrize("seed", SEEDS)
def test_leaf_nbytes_and_dtype_names(seed):
    tl, jl = _leaves(seed)
    assert [tb.leaf_nbytes(t) for t in tl] == [jb.leaf_nbytes(j) for j in jl]
    assert [tb.dtype_name(t.dtype) for t in tl] == \
        [str(j.dtype) for j in jl]
    for name in DTYPES:          # dtype names, "torch."-prefixed or not
        for prefix in ("", "torch."):
            assert tb.leaf_nbytes(tb._SigLeaf((3, 5), prefix + name)) == \
                jb.leaf_nbytes(jnp.zeros((3, 5), getattr(jnp, name)))


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_partitions_and_digests(seed, threshold):
    tl, jl = _leaves(seed)
    by_dtype_t = lambda i, leaf: tb.dtype_name(leaf.dtype)  # noqa: E731
    by_dtype_j = lambda i, leaf: str(leaf.dtype)            # noqa: E731
    for key_t, key_j in ((None, None), (by_dtype_t, by_dtype_j)):
        got = tb.partition_buckets(tl, threshold, key_t)
        want = jb.partition_buckets(jl, threshold, key_j)
        assert got == want
        tags = ["none", "fp16", "bf16", "powersgd:4"] * len(got)
        assert tb.assignment_digest(got) == jb.assignment_digest(want)
        assert tb.assignment_digest(got, tags[:len(got)]) == \
            jb.assignment_digest(want, tags[:len(want)])
        assert tb.partition_digest(tl, threshold, key_t) == \
            jb.partition_digest(jl, threshold, key_j)
    assert tb.partition_cached(tl, threshold) == \
        jb.partition_cached(jl, threshold)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_by_dtype_and_partition_tree(seed):
    tl, jl = _leaves(seed)
    assert tb.split_by_dtype(tl) == jb.split_by_dtype(jl)
    assert tb.split_by_dtype([t.dtype for t in tl]) == \
        jb.split_by_dtype([j.dtype for j in jl])
    names = [f"k{(7 * i) % len(tl):02d}" for i in range(len(tl))]
    ttree = {"outer": dict(zip(names, tl)), "tail": [tl[0], (tl[1],)]}
    jtree = {"outer": dict(zip(names, jl)), "tail": [jl[0], (jl[1],)]}
    for threshold in THRESHOLDS:
        assert tb.partition_tree(ttree, threshold) == \
            jb.partition_tree(jtree, threshold)
    assert [tb.leaf_nbytes(x) for x in tb.tree_leaves(ttree)] == \
        [jb.leaf_nbytes(x) for x in jax.tree_util.tree_leaves(jtree)]


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("data",))


@pytest.mark.parametrize("compression", ["none", "fp16", "bf16"])
@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("threshold", [64, 700, 1 << 20])
def test_plan_overlap_on_a_dict_tree(threshold, guard, compression):
    tl, jl = _leaves(4)
    names = [f"p{i:02d}" for i in range(len(tl))]
    ttree, jtree = dict(zip(names, tl)), dict(zip(names, jl))
    for n in (1, 2, 3):
        got = ttrain.plan_overlap(ttree, tmesh.Mesh({"data": n}),
                                  overlap_threshold=threshold, guard=guard,
                                  compression=compression)
        want = jtrain.plan_overlap(jtree, _jmesh(n),
                                   overlap_threshold=threshold, guard=guard,
                                   compression=compression)
        assert tuple(got) == tuple(want)
        assert bool(got.bucket_leaf_indices) == (n > 1)


def test_plan_of_the_flagship_in_the_jax_layout():
    """A 2-layer narrow bf16 flagship: the port's parameters carried to
    the JAX layout (``params_to_jax``; bf16 comes back as float32, so
    the dtypes are restored) plan as the reference's own tree does."""
    kw = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
              head_dim=32, d_ff=256, max_seq=64)
    tcfg = ttfm.TransformerConfig(**kw)                 # bfloat16
    model = ttfm.init_params(tcfg, seed=0, device="cpu")
    named = ttfm.params_to_jax(tcfg, model)
    jcfg = jtfm.TransformerConfig(**kw, dtype=jnp.bfloat16, tp_axis=None,
                                  sp_axis=None, ep_axis=None)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    from horovod_tpu import weights as jweights
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
                                      guard=guard)
            want = jtrain.plan_overlap(jparams, _jmesh(2),
                                       overlap_threshold=threshold,
                                       guard=guard)
            assert tuple(got) == tuple(want)


def _reference_digest(model, threshold):
    leaves = [jax.ShapeDtypeStruct(tuple(p.shape), getattr(
        jnp, tb.dtype_name(p.dtype))) for p in model.parameters()]
    return jb.assignment_digest(jb.partition_buckets(leaves, threshold))


@pytest.mark.parametrize("threshold", [1 << 16, 1 << 20, 64 << 20])
def test_plan_over_named_parameters_is_the_reference_partition(threshold):
    kw = dict(vocab=256, d_model=128, n_layers=3, n_heads=4, n_kv_heads=2,
              head_dim=32, d_ff=256, max_seq=64)
    model = ttfm.Transformer(ttfm.TransformerConfig(**kw),
                             torch.device("meta"))
    plan = ttrain.plan_overlap(model, tmesh.Mesh({"data": 2}),
                               overlap_threshold=threshold, guard=False)
    assert plan.digest == _reference_digest(model, threshold)
    assert plan.n_leaves == 2 + 9 * 3


def test_flagship_plan_at_full_width():
    """Llama-2-7B width, 2 layers, 64 MiB: 13 buckets; with the guard
    the flag rides the two float32 norm buckets only, and an fp16 wire
    moves as many bytes as bf16 gradients already do."""
    model = ttfm.Transformer(ttfm.TransformerConfig(**LLAMA2_7B_2),
                             torch.device("meta"))
    assert _reference_digest(model, 64 << 20) == FLAGSHIP_DIGEST
    mesh = tmesh.Mesh({"data": 2})
    plan = ttrain.plan_overlap(model, mesh, overlap_threshold=64 << 20,
                               guard=True, compression="none")
    assert plan.digest == FLAGSHIP_DIGEST
    assert len(plan.bucket_leaf_indices) == 13
    assert [any(g.rides_flag for g in w) for w in plan.wire] == \
        [b in (5, 11) for b in range(13)]
    fp16 = ttrain.plan_overlap(model, mesh, overlap_threshold=64 << 20,
                               guard=True, compression="fp16")
    assert fp16.digest == ";".join(f"{e}|c=fp16"
                                   for e in FLAGSHIP_DIGEST.split(";"))
    raw = sum(plan.bucket_nbytes)
    assert raw == 535842816 * 2 + 4 * 4096 * 5 - 2 * 4096 * 5
    assert ttrain._wire_bytes(fp16) == raw - 2 * 4096 * 5
