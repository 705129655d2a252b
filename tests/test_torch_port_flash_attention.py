"""horovod_tpu_torch flash-attention forward (plain version, as it runs
on the CPU) and the port's attention() against the JAX package.

References: ``horovod_tpu.parallel.ring_attention.attention`` with
HOROVOD_FLASH_ATTENTION unset (its einsum path), the Pallas library's
``mha_reference`` (the TPU kernel itself cannot run on the CPU), and
``logsumexp`` of the JAX scores for lse.

Tolerances, as max abs error over max |reference|: float32 1e-4
(summation order only); bfloat16 3e-2 (bf16 rounds at different places
in XLA and PyTorch, and mha_reference keeps its scores in bf16).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring_attention as tra

# The JAX package's parallel/__init__ re-exports a function named
# ring_attention over the submodule of that name.
jra = importlib.import_module("horovod_tpu.parallel.ring_attention")

B, L, H, D = 2, 128, 4, 64
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, L, H, D).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, ref, rel):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    bound = rel * float(np.max(np.abs(ref)))
    assert err <= bound, f"max abs err {err} > {bound}"


def _jax_lse(q, k, causal):
    s = jra._blockwise_scores(q.astype(jnp.float32),
                              k.astype(jnp.float32), D ** -0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((L, L), bool))[None, None], s,
                      -jnp.inf)
    return jax.scipy.special.logsumexp(s, axis=-1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_attention_and_library_reference(
        dtype, causal, monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    (jq, jk, jv), (tq, tk, tv) = _inputs(dtype)
    before = fa.launches
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal)
    assert fa.launches == before          # CPU: plain version, no launch
    assert o.dtype == TORCH[dtype] and o.shape == (B, L, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, L)

    _assert_close(o, jra.attention(jq, jk, jv, causal=causal), TOL[dtype])
    ref = jfa.mha_reference(
        *(jnp.swapaxes(x, 1, 2) for x in (jq, jk, jv)), None,
        causal=causal, sm_scale=D ** -0.5)
    _assert_close(o, jnp.swapaxes(ref, 1, 2), TOL[dtype])
    _assert_close(lse, _jax_lse(jq, jk, causal), TOL["float32"])


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_attention_matches_jax(dtype, causal, mode, monkeypatch):
    """CPU tensors take the plain path whatever HOROVOD_FLASH_ATTENTION
    says (the port does not read the knob)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(dtype, seed=1)
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    ref = jra.attention(jq, jk, jv, causal=causal)
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", mode)
    before = fa.launches
    got = tra.attention(tq, tk, tv, causal=causal)
    assert fa.launches == before
    assert got.dtype == TORCH[dtype]
    _assert_close(got, ref, TOL[dtype])


@pytest.mark.parametrize("shape_q,shape_k,dtype", [
    ((B, L, H, 48), (B, L, H, 48), torch.float32),     # head dim
    ((B, 100, H, D), (B, 100, H, D), torch.float32),   # L % 128
    ((B, L, H, D), (B, L, H // 2, D), torch.float32),  # GQA not repeated
    ((B, L, H, D), (B, L, H, D), torch.float16),       # dtype
])
def test_unsupported_inputs_raise_before_launch(shape_q, shape_k, dtype):
    q = torch.zeros(shape_q, dtype=dtype)
    k = torch.zeros(shape_k, dtype=dtype)
    before = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, k)
    assert fa.launches == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    q = torch.zeros((B, L, H, D), device="meta")
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("shape_q,shape_k", [
    ((B, L, H, D), (B, L, H, D)),
    ((B, 256, H, 128), (B, 256, H, 128)),
    ((1, L, 2, 256), (1, L, 2, 256)),
    ((B, L, H, 48), (B, L, H, 48)),
    ((B, 100, H, D), (B, 100, H, D)),
    ((B, L, H, D), (B, L, H // 2, D)),
])
def test_kernel_shape_rule_matches_jax(shape_q, shape_k, monkeypatch):
    """check_inputs admits exactly the shapes the JAX _flash_supported
    admits on its kernel's backend."""
    monkeypatch.setattr(jra.jax, "default_backend", lambda: "tpu")
    jax_ok = jra._flash_supported(jnp.zeros(shape_q), jnp.zeros(shape_k))
    q, k = torch.zeros(shape_q), torch.zeros(shape_k)
    try:
        fa.check_inputs(q, k, k)
        port_ok = True
    except ValueError:
        port_ok = False
    assert port_ok == jax_ok


def test_cpu_attention_takes_shapes_the_kernel_does_not(monkeypatch):
    """The plain path has no shape rule: L % 128 != 0 and an odd head
    dim still match the JAX einsum path, with no launch."""
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    rng = np.random.RandomState(2)
    arrs = [rng.randn(1, 100, 2, 48).astype(np.float32) for _ in range(3)]
    before = fa.launches
    got = tra.attention(*(torch.from_numpy(a) for a in arrs))
    assert fa.launches == before
    _assert_close(got, jra.attention(*(jnp.asarray(a) for a in arrs)),
                  TOL["float32"])


# ---------------------------------------------------------------------------
# Backward. Measure: chip_smoke's worst (b, h) slice relative error (the
# Frobenius norm of the error over that of the reference, per (b, h)
# slice of dq, dk and dv). Tolerances: float32 1e-5 (summation order
# only); bfloat16 1e-2 (both sides compute in float32 from the same bf16
# inputs and round the gradients to bf16; the plain version takes di
# from the bf16 o, the JAX VJP from its float32 softmax).

BWD_L = 256
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _bwd_inputs(dtype, D, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, BWD_L, H, D).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _swap(x):
    return jnp.swapaxes(x, 1, 2)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp_and_library_reference(
        dtype, causal, D, monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bwd_inputs(dtype, D, seed=3)
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, causal)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    assert all(g.dtype == TORCH[dtype] and g.shape == tq.shape for g in got)

    _, vjp = jax.vjp(lambda q, k, v: jra.attention(q, k, v, causal=causal),
                     jq, jk, jv)
    ref = [_np(r) for r in vjp(jdo)]
    assert chip_smoke.grads_rel_err(got, ref) <= BWD_TOL[dtype]

    # mha_reference_bwd takes sm_scale == 1 only: give it q * scale,
    # m = lse and l = 1 (so p = exp(s - lse)), and scale dq back.
    scale = D ** -0.5
    jo = jnp.asarray(_np(o), JNP[dtype])
    jlse = jnp.asarray(lse.numpy())
    dq, dk, dv, _ = jfa.mha_reference_bwd(
        _swap(jnp.asarray(_np(tq)) * scale), _swap(jk), _swap(jv), None,
        None, _swap(jo), jnp.ones_like(jlse), jlse, _swap(jdo),
        causal=causal)
    lib = [_np(_swap(dq)) * scale, _np(_swap(dk)), _np(_swap(dv))]
    assert chip_smoke.grads_rel_err(got, lib) <= BWD_TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_gradient_is_the_flash_backward(dtype, causal):
    """attention() is one autograd node, FlashAttention's, on every
    device: its gradient on the CPU is the plain backward's, bit for
    bit."""
    _, (tq, tk, tv, tdo) = _bwd_inputs(dtype, 64, seed=4)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = tra.attention(q, k, v, causal=causal)
    assert isinstance(out.grad_fn, fa.FlashAttention._backward_cls)
    out.backward(tdo)
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, causal)
    ref = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["o_dtype", "do_shape", "lse_dtype",
                                 "lse_shape", "head_dim"])
def test_backward_checks_its_inputs_before_launch(bad):
    _, (q, k, v, do) = _bwd_inputs("float32", 64, seed=5)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, True)
    if bad == "o_dtype":
        o = o.to(torch.bfloat16)
    elif bad == "do_shape":
        do = do[:, :128]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "lse_shape":
        lse = lse.transpose(1, 2)
    else:
        q, k, v, o, do = (x[..., :48] for x in (q, k, v, o, do))
    before = (fa.launches_dkv, fa.launches_dq)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert (fa.launches_dkv, fa.launches_dq) == before


def test_backward_on_the_cpu_is_the_plain_version():
    _, (q, k, v, do) = _bwd_inputs("float32", 64, seed=6)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    before = (fa.launches_dkv, fa.launches_dq)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert (fa.launches_dkv, fa.launches_dq) == before
    for g, r in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      True)):
        assert torch.equal(g, r)
    meta = [x.to("meta") for x in (q, k, v, o, lse, do)]
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        fa.flash_attention_bwd(*meta)
