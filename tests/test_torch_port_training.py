"""The training slice against the JAX package on the CPU: the loss,
every parameter's gradient, remat, and AdamW steps through
``build_train_step``, on weights carried across with
``params_from_jax`` and compared in the JAX layout through
``params_to_jax``.

Small config: 2 layers, d_model 128, 4 heads over 2 KV heads (GQA's
repeat runs), head_dim 32, L = 256, vocab 256; tokens from a seeded
numpy generator. Measure: chip_smoke's ``rel_err``, the Frobenius norm
of the error over that of the reference, per parameter (each layer's
slice of a stacked JAX leaf on its own) and for the loss. Tolerances:
float32 1e-6 for the loss and 1e-5 for the gradients (summation order
through two layers and the float32 LM head; seen: 8e-8 and 9e-7), 1e-5
for the parameters after 3 AdamW steps (Adam's normalised update
amplifies float32 noise in small gradients; seen: 2e-7); bfloat16 1e-4
for the loss and 3e-2 for the gradients (every activation rounds to
bf16 at different places in XLA and PyTorch; seen: 1.5e-6 and 1.2e-2).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from horovod_tpu import weights as jweights
from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring_attention as tra
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import train as ttrain

# The JAX package's parallel/__init__ re-exports build_train_step; the
# module holds it under the same name.
jtrain = importlib.import_module("horovod_tpu.parallel.train")

L = 256
SMALL = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, d_ff=256, max_seq=L)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL_GRAD = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_LOSS = {"float32": 1e-6, "bfloat16": 1e-4}
TOL_PARAMS = 1e-5
LR = 3e-4


@pytest.fixture(autouse=True)
def _einsum_attention(monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)


def configs(dtype, **kw):
    jcfg = jtfm.TransformerConfig(**SMALL, dtype=JNP[dtype], tp_axis=None,
                                  sp_axis=None, ep_axis=None, **kw)
    tcfg = ttfm.TransformerConfig(**SMALL, dtype=TORCH[dtype], **kw)
    return jcfg, tcfg


def transplanted(dtype, **kw):
    jcfg, tcfg = configs(dtype, **kw)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    named = {n: np.asarray(a) for n, a in jweights.named_leaves(jparams)}
    return jcfg, tcfg, jparams, ttfm.params_from_jax(tcfg, named,
                                                     device="cpu")


def batches(seed=7):
    tokens = np.random.RandomState(seed).randint(
        0, SMALL["vocab"], (2, L)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return ({"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)})


def jax_named(tree):
    return {n: np.asarray(jnp.asarray(a, jnp.float32))
            for n, a in jweights.named_leaves(tree)}


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters()}


def worst_rel_err(got, ref):
    """(worst error, its leaf name) over every leaf, each layer's slice
    of a stacked leaf on its own."""
    assert sorted(got) == sorted(ref)
    errs = {}
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        if name.startswith("['layers']"):
            for i in range(r.shape[0]):
                errs[f"{name}[{i}]"] = chip_smoke.rel_err(g[i], r[i])
        else:
            errs[name] = chip_smoke.rel_err(g, r)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def test_vocab_parallel_xent_matches_jax():
    jcfg, tcfg = configs("float32")
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, L, SMALL["vocab"]) * 3).astype(np.float32)
    targets = rng.randint(0, SMALL["vocab"], (2, L)).astype(np.int32)
    ref = jtfm.vocab_parallel_xent(jcfg, jnp.asarray(logits),
                                   jnp.asarray(targets))
    got = ttfm.vocab_parallel_xent(tcfg, torch.from_numpy(logits),
                                   torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == (2, L)
    assert chip_smoke.rel_err(got, np.asarray(ref)) <= 1e-6


def test_vocab_parallel_xent_refuses_a_vocab_shard():
    _, tcfg = configs("float32")
    shard = torch.zeros(2, L, SMALL["vocab"] // 2)
    with pytest.raises(NotImplementedError, match="tensor"):
        ttfm.vocab_parallel_xent(tcfg, shard, torch.zeros(2, L).long())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_jax(dtype):
    jcfg, tcfg, jparams, model = transplanted(dtype)
    jbatch, tbatch = batches()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, jbatch))(jparams)
    loss = ttfm.loss_fn(tcfg, model, tbatch)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert chip_smoke.rel_err(loss, np.asarray(jloss)) <= TOL_LOSS[dtype]
    err, leaf = worst_rel_err(ttfm.params_to_jax(tcfg, grads_of(model)),
                              jax_named(jgrads))
    assert err <= TOL_GRAD[dtype], leaf


def test_params_to_jax_inverts_params_from_jax():
    jcfg, tcfg, jparams, model = transplanted("float32")
    back = ttfm.params_to_jax(tcfg, model)
    ref = jax_named(jparams)
    assert sorted(back) == sorted(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    missing = dict(model.named_parameters(), **{"layers.0.wq": None})
    with pytest.raises(ValueError, match="layers.0.wq"):
        ttfm.params_to_jax(tcfg, missing)


@pytest.mark.parametrize("mode", ["full", "mlp_only"])
def test_remat_gives_the_same_loss_and_gradients(mode):
    _, tcfg, _, model = transplanted("float32")
    _, rcfg, _, rmodel = transplanted("float32", remat=True, remat_mode=mode)
    _, tbatch = batches()
    loss = ttfm.loss_fn(tcfg, model, tbatch)
    loss.backward()
    rloss = ttfm.loss_fn(rcfg, rmodel, tbatch)
    rloss.backward()
    assert torch.equal(rloss, loss)
    for (name, p), rp in zip(model.named_parameters(), rmodel.parameters()):
        assert torch.equal(rp.grad, p.grad), name


def test_remat_mode_is_checked():
    _, tcfg, _, model = transplanted("float32", remat=True,
                                     remat_mode="attention_only")
    _, tbatch = batches()
    with pytest.raises(ValueError, match="remat_mode"):
        ttfm.loss_fn(tcfg, model, tbatch)


def test_adamw_steps_match_jax_build_train_step():
    jcfg, tcfg, jparams, model = transplanted("float32")
    jbatch, tbatch = batches()
    mesh = Mesh(np.array(jax.devices()[:1]), axis_names=("data",))
    tx = optax.adamw(LR)
    jstep = jtrain.build_train_step(
        lambda p, b: jtfm.loss_fn(jcfg, p, b), tx, mesh, overlap=False,
        donate=False)
    opt_state = tx.init(jparams)
    optimizer = ttrain.adamw(model.parameters(), LR)
    step = ttrain.build_train_step(
        lambda m, b: ttfm.loss_fn(tcfg, m, b), optimizer, "cpu")
    for i in range(3):
        jparams, opt_state, jmetrics = jstep(jparams, opt_state, jbatch)
        metrics = step(model, tbatch)
        assert set(metrics) == set(jmetrics) == {"loss"}
        assert chip_smoke.rel_err(metrics["loss"],
                                  np.asarray(jmetrics["loss"])) \
            <= TOL_LOSS["float32"], i
    err, leaf = worst_rel_err(ttfm.params_to_jax(tcfg, model),
                              jax_named(jparams))
    assert err <= TOL_PARAMS, leaf


def test_adamw_has_optax_defaults():
    opt = ttrain.adamw([torch.nn.Parameter(torch.zeros(2))], LR)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (LR, (0.9, 0.999), 1e-8, 1e-4)


def test_train_step_reports_aux_like_jax():
    _, tcfg, _, model = transplanted("float32")
    _, tbatch = batches()
    optimizer = ttrain.adamw(model.parameters(), LR)

    def loss_with_aux(m, b):
        hidden, aux = ttfm.forward(tcfg, m, b["tokens"])
        nll = ttfm.vocab_parallel_xent(
            tcfg, ttfm.logits_fn(tcfg, m, hidden), b["targets"])
        return nll.mean() + 0.01 * aux, {"moe_aux": aux}

    step = ttrain.build_train_step(loss_with_aux, optimizer, "cpu",
                                   loss_has_aux=True)
    metrics = step(model, tbatch)
    assert set(metrics) == {"loss", "aux"}
    assert not metrics["loss"].requires_grad
    assert float(metrics["aux"]["moe_aux"]) == 0.0


@pytest.mark.parametrize("kw,error,match", [
    ({"compression": "powersgd", "overlap": False}, ValueError,
     "requires the bucketed overlap path"),
    ({"mesh": tmesh.Mesh({"data": 2, "tensor": 2})}, NotImplementedError,
     "A.9"),
    ({"compression": "fp16", "overlap": False}, ValueError,
     "requires the bucketed overlap path"),
    ({"compression": "powersgd:0"}, ValueError, "rank must be >= 1")])
def test_train_step_refuses_what_the_nccl_slice_brings(kw, error, match):
    """What the data-parallel step refuses: a mesh axis that shards the
    model (ROADMAP A.9), a wire cast or PowerSGD without the buckets
    that carry it, and a PowerSGD rank below 1 (the reference's
    ValueErrors)."""
    opt = ttrain.adamw([torch.nn.Parameter(torch.zeros(2))], LR)
    with pytest.raises(error, match=match):
        ttrain.build_train_step(lambda m, b: 0, opt, "cpu", **kw)


def test_train_step_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = ttrain.adamw([torch.nn.Parameter(torch.zeros(2))], LR)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttrain.build_train_step(lambda m, b: 0, opt)
    ttrain.build_train_step(lambda m, b: 0, opt, overlap=False,
                            compression="none", device="cpu")


def test_gradients_reach_the_attention_weights_through_a_kernel_output(
        monkeypatch):
    """A CUDA kernel's outputs carry no autograd history (ctypes fills
    tensors the wrapper allocated). Emulated here by detaching the plain
    forward's outputs: wq, wk, wv and attn_norm still get their
    gradient, and it is the JAX package's."""
    plain = fa.flash_attention_fwd_plain

    def as_a_kernel_returns(*args, **kwargs):
        return tuple(t.detach() for t in plain(*args, **kwargs))

    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        as_a_kernel_returns)
    monkeypatch.setattr(tra, "flash_attention_fwd_plain",
                        as_a_kernel_returns, raising=False)
    jcfg, tcfg, jparams, model = transplanted("float32")
    jbatch, tbatch = batches()
    ttfm.loss_fn(tcfg, model, tbatch).backward()
    jgrads = jax_named(jax.grad(
        lambda p: jtfm.loss_fn(jcfg, p, jbatch))(jparams))
    got = ttfm.params_to_jax(tcfg, grads_of(model))
    for name in ("wq", "wk", "wv", "attn_norm"):
        leaf = f"['layers']['{name}']"
        assert np.abs(got[leaf]).max() > 0, leaf
        err, _ = worst_rel_err({leaf: got[leaf]}, {leaf: jgrads[leaf]})
        assert err <= TOL_GRAD["float32"], leaf


def test_tied_head_on_the_card_is_one_mixed_precision_product():
    """The LM head's card path (``_TiedHead``, traced here on the meta
    device, which has the CUDA path's ``aten::mm.dtype`` shapes): the
    forward is one bf16 x bf16 product with float32 logits, and neither
    direction makes a float32 copy of the embedding (no op takes the
    embedding and gives float32 but the mixed products themselves)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    V, Dm, M = 512, 64, 48
    e = torch.empty((V, Dm), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    h = torch.empty((M, Dm), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            self.calls.append((str(func), ins, out))
            return out

    with Ops() as fwd_ops:
        logits = ttfm._TiedHead.apply(h, e)
    assert logits.dtype == torch.float32 and logits.shape == (M, V)
    with Ops() as bwd_ops:
        logits.backward(torch.empty_like(logits))
    assert e.grad.dtype == torch.bfloat16 and e.grad.shape == (V, Dm)
    assert h.grad.dtype == torch.bfloat16 and h.grad.shape == (M, Dm)
    mm = [c for c in fwd_ops.calls if "mm" in c[0]]
    assert [c[0] for c in mm] == ["aten.mm.dtype"]
    for name, ins, out in fwd_ops.calls + bwd_ops.calls:
        takes_embed = any(t.shape in ((V, Dm), (Dm, V)) for t in ins)
        if takes_embed and isinstance(out, torch.Tensor) \
                and out.dtype == torch.float32:
            assert name == "aten.mm.dtype", name


def test_lm_head_keeps_the_float32_product_on_the_cpu():
    jcfg, tcfg, jparams, model = transplanted("bfloat16")
    hidden = torch.from_numpy(np.random.RandomState(3).randn(
        2, 8, SMALL["d_model"]).astype(np.float32)).to(torch.bfloat16)
    got = ttfm.logits_fn(tcfg, model, hidden)
    want = torch.einsum("bld,vd->blv", hidden.float(), model.embed.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
