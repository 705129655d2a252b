"""horovod_tpu_torch flash-attention forward (plain version, as it runs
on the CPU) and the port's attention() against the JAX package.

References: ``horovod_tpu.parallel.ring_attention.attention`` with
HOROVOD_FLASH_ATTENTION unset (its einsum path), the Pallas library's
``mha_reference`` (the TPU kernel itself cannot run on the CPU), and
``logsumexp`` of the JAX scores for lse.

Tolerances, as max abs error over max |reference|: float32 1e-4
(summation order only); bfloat16 3e-2 (bf16 rounds at different places
in XLA and PyTorch, and mha_reference keeps its scores in bf16); float16
3e-3 (the same, with 3 more mantissa bits).
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
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 3e-3}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


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
    ((B, L, H, 288), (B, L, H, 288), torch.float32),   # head dim > 256
    ((B, 0, H, D), (B, 0, H, D), torch.float32),       # L == 0
    ((B, L, H, D), (B, L, H // 2, D), torch.float32),  # GQA not repeated
    ((B, L, H, D), (B, L, H, D), torch.float64),       # dtype
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
    ((B, 100, H, 16), (B, 100, H, 16)),
    ((B, L, H, 288), (B, L, H, 288)),
])
def test_kernel_shape_rule_matches_jax(shape_q, shape_k, monkeypatch):
    """check_inputs admits what the JAX _flash_supported admits on its
    kernel's backend and, as declared differences, a sequence length
    that is not a multiple of 128 (the CUDA kernels mask a ragged last
    tile) and any head dim D <= 256 (the wrapper zero-pads it to the
    next kernel width); the JAX package's einsum path computes both.
    Above 256 both refuse the kernel."""
    monkeypatch.setattr(jra.jax, "default_backend", lambda: "tpu")
    jax_ok = jra._flash_supported(jnp.zeros(shape_q), jnp.zeros(shape_k))
    q, k = torch.zeros(shape_q), torch.zeros(shape_k)
    try:
        fa.check_inputs(q, k, k)
        port_ok = True
    except ValueError:
        port_ok = False
    declared = shape_q == shape_k and shape_q[-1] <= fa.MAX_HEAD_DIM \
        and (shape_q[1] % 128 != 0
             or shape_q[-1] not in fa.KERNEL_HEAD_DIMS)
    assert port_ok == (jax_ok or declared)


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
    else:                                         # D = 288 > 256
        q, k, v, o, do = (torch.cat([x] * 4 + [x[..., :32]], -1)
                          for x in (q, k, v, o, do))
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


# ---------------------------------------------------------------------------
# Ragged sequence lengths and float16: the kernels take them (check_inputs
# admits them on every device), and the port's attention there matches the
# JAX package's einsum path, forward and gradient.

@pytest.mark.parametrize("L_", [16, 1000, 2047])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_kernels_take_ragged_lengths_and_float16(L_, dtype):
    q = torch.zeros((1, L_, 2, 64), dtype=dtype)
    fa.check_inputs(q, q, q)
    fa.check_inputs(q.to("meta"), q.to("meta"), q.to("meta"))


def test_head_dims_outside_the_kernels_name_the_declared_difference():
    q = torch.zeros((1, 16, 2, 288))
    with pytest.raises(ValueError, match="declared difference"):
        fa.check_inputs(q, q, q)


def test_float64_names_the_declared_difference():
    q = torch.zeros((1, 16, 2, 64), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"float64 among them\) are a "
                                         r"declared difference from the JAX "
                                         r"package's einsum path"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("L_", [16, 1000])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_port_attention_at_ragged_lengths_matches_jax(L_, dtype,
                                                      monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    rng = np.random.RandomState(L_)
    arrs = [rng.randn(1, L_, 2, 64).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a, JNP[dtype]) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TORCH[dtype])
                       .requires_grad_() for a in arrs)
    ref, vjp = jax.vjp(lambda q, k, v: jra.attention(q, k, v, causal=True),
                       jq, jk, jv)
    got = tra.attention(tq, tk, tv, causal=True)
    assert got.dtype == TORCH[dtype]
    _assert_close(got.detach(), ref, TOL[dtype])
    got.backward(tdo)
    for g, r in zip((tq.grad, tk.grad, tv.grad), vjp(jdo)):
        _assert_close(g, r, TOL[dtype])


# ---------------------------------------------------------------------------
# Head dims the kernels are not built for: on CUDA tensors the wrapper
# zero-pads D to the next kernel width, launches with the real D's scale
# and cuts the outputs back (pad_head_dim / cut_head_dim). Here the same
# pad and cut go around the plain versions: in float32 the result must
# equal the unpadded plain version up to the order of sums (1e-6
# relative, Frobenius norm of each tensor), and the padded columns must
# be exactly zero.

PAD_TOL = 1e-6


@pytest.mark.parametrize("D_", [16, 48, 80, 96, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_pad_is_exact_forward_and_backward(D_, causal):
    rng = np.random.RandomState(D_)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 100, 3, D_)
                                    .astype(np.float32)) for _ in range(4))
    Dp = fa.kernel_head_dim(D_)
    assert Dp in fa.KERNEL_HEAD_DIMS and Dp > D_
    scale = D_ ** -0.5
    qp, kp, vp, dop = (fa.pad_head_dim(t, Dp) for t in (q, k, v, do))
    assert qp.shape[-1] == Dp and qp.is_contiguous()

    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    o_pad, lse = fa.flash_attention_fwd_plain(qp, kp, vp, causal, scale)
    assert not o_pad[..., D_:].any()
    o = fa.cut_head_dim(o_pad, D_)
    assert o.shape == q.shape and o.is_contiguous()
    assert chip_smoke.rel_err(o, o_ref) <= PAD_TOL
    assert chip_smoke.rel_err(lse, lse_ref) <= PAD_TOL

    ref = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, causal,
                                       scale)
    got_pad = fa.flash_attention_bwd_plain(qp, kp, vp, o_pad, lse, dop,
                                           causal, scale)
    for g in got_pad:
        assert not g[..., D_:].any()
    got = [fa.cut_head_dim(g, D_) for g in got_pad]
    for g, r in zip(got, ref):
        assert chip_smoke.rel_err(g, r) <= PAD_TOL


@pytest.mark.parametrize("D_", [64, 128, 256])
def test_head_dim_pad_copies_nothing_at_kernel_widths(D_):
    t = torch.zeros((1, 4, 2, D_))
    assert fa.kernel_head_dim(D_) == D_
    assert fa.pad_head_dim(t, D_) is t
    assert fa.cut_head_dim(t, D_) is t


@pytest.mark.parametrize("D_", [16, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_dims_match_jax(D_, dtype, monkeypatch):
    """attention() at a head dim the kernels are not built for, and the
    wrapper's pad -> plain -> cut around it, against the JAX package's
    attention and its VJP."""
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    rng = np.random.RandomState(D_ + 7)
    arrs = [rng.randn(1, 128, 2, D_).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a, JNP[dtype]) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TORCH[dtype])
                       for a in arrs)
    ref, vjp = jax.vjp(lambda q, k, v: jra.attention(q, k, v, causal=True),
                       jq, jk, jv)
    jgrads = vjp(jdo)

    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    got = tra.attention(q, k, v, causal=True)
    _assert_close(got.detach(), ref, TOL[dtype])
    got.backward(tdo)
    for g, r in zip((q.grad, k.grad, v.grad), jgrads):
        _assert_close(g, r, TOL[dtype])

    Dp, scale = fa.kernel_head_dim(D_), D_ ** -0.5
    qp, kp, vp, dop = (fa.pad_head_dim(t, Dp) for t in (tq, tk, tv, tdo))
    o_pad, lse = fa.flash_attention_fwd_plain(qp, kp, vp, True, scale)
    _assert_close(fa.cut_head_dim(o_pad, D_), ref, TOL[dtype])
    grads = fa.flash_attention_bwd_plain(qp, kp, vp, o_pad, lse, dop, True,
                                         scale)
    for g, r in zip(grads, jgrads):
        _assert_close(fa.cut_head_dim(g, D_), r, TOL[dtype])
