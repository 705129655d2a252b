"""horovod_tpu_torch's CUDA kernels on the card: the flash-attention
forward and its dK/dV and dQ backward kernels against their plain
versions (ragged lengths, float16 and head dims the wrapper pads
included), the dK/dV and dQ kernels' failed tensor-map encodes and
ptxas's spill reports, the forward's and the backward's bitwise
repeatability, the Adasum kernels K1 and K2 against theirs, their
launch counters, attention() on CUDA
tensors, the tied LM head's mixed product against the float32 one, and
the serving (both ladders), training and two-rank gloo Adasum paths
through the kernels.

Marked ``cuda``; every test takes the ``card`` fixture, which skips
without an NVIDIA card. This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py

Tolerances, on the worst query row's relative error of o (2-norm of
the error over the 2-norm of the plain row): bfloat16 1e-2 (bf16
rounding of P before the P V product, and of o); float32 1e-5
(summation order only). lse, on max abs error: 1e-4. Backward, on
chip_smoke's worst (b, h) slice relative error of dq, dk and dv, and
model gradients (kernels against the plain versions) on its
per-parameter relative error: chip_smoke's TOL_SLICE and TOL_GRAD, for
the reasons it gives. Adasum: chip_smoke's TOL_DOT and TOL_COMBINE
(phase 8). The LM head: logits 1e-5 (float32 sums in another order),
gradients one bf16 rounding (TOL_COMBINE[bf16]).
"""

import subprocess
import time

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import adasum_kernels as ak
from horovod_tpu_torch.ops.adasum import adasum_reference
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring_attention as ra
from horovod_tpu_torch.parallel import train

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
TOL_LSE = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run on the card "
                    "with --noconftest (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def _abs(got, ref):
    return float((got - ref).abs().max())


def _qkv(card, shape, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=card).to(dtype)
            for _ in range(3)]


# Head dims the kernels are built for, and ones the wrapper zero-pads to
# the next of them.
HEAD_DIMS = [64, 128, 256, 16, 80, 96, 192]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_kernel_matches_plain(card, D, causal, dtype):
    q, k, v = _qkv(card, (2, 256, 3, D), dtype)
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _rel(o, o_ref) <= TOL[dtype]
    assert _abs(lse, lse_ref) <= TOL_LSE


def test_kernel_reads_strided_inputs_in_place(card):
    """q, k, v as views of one packed (B, L, 3, H, D) projection."""
    qkv = torch.randn((2, 256, 3, 4, 128), device=card).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
    assert _rel(o, o_ref) <= TOL[torch.bfloat16]
    assert _abs(lse, lse_ref) <= TOL_LSE


def test_kernel_reads_head_major_views_in_place(card):
    """q, k, v as (B, L, H, D) views of (B, H, L, D) tensors: the
    tensor maps take strides in any order."""
    q, k, v = (t.transpose(1, 2) for t in
               _qkv(card, (2, 4, 384, 128), torch.bfloat16))
    assert q.stride(2) > q.stride(1)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
    assert _rel(o, o_ref) <= TOL[torch.bfloat16]
    assert _abs(lse, lse_ref) <= TOL_LSE


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_forward_is_bitwise_repeatable(card, D, causal, dtype):
    q, k, v = _qkv(card, (2, 1000, 4, D), dtype, seed=D)
    first = fa.flash_attention_fwd(q, k, v, causal)
    again = fa.flash_attention_fwd(q, k, v, causal)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("L", [1, 127, 129])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_forward_at_lengths_around_one_tile(card, L, causal, D):
    """Shorter than, one short of and one past the kernel's 128-row
    query tile (and its 64- or 128-key tile)."""
    q, k, v = _qkv(card, (2, L, 3, D), torch.bfloat16, seed=L)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    assert o.shape == q.shape and o.is_contiguous()
    assert _rel(o, o_ref) <= TOL[torch.bfloat16]
    assert _abs(lse, lse_ref) <= TOL_LSE


def test_unsupported_shape_raises_before_launch(card):
    q, k, v = _qkv(card, (1, 128, 2, 288), torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v)
    assert fa.launches == before


def test_attention_modes_on_the_card(card, monkeypatch):
    """CUDA tensors launch the kernel whatever HOROVOD_FLASH_ATTENTION
    says, and a shape the kernel does not take raises."""
    q, k, v = _qkv(card, (1, 256, 2, 64), torch.bfloat16)
    small = _qkv(card, (1, 256, 2, 288), torch.bfloat16)
    ref = fa.flash_attention_fwd_plain(q, k, v, True)[0]
    for mode in ("0", "1", "auto", None):
        if mode is None:
            monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", mode)
        before = fa.launches
        out = ra.attention(q, k, v, causal=True)
        assert fa.launches == before + 1, mode
        assert _rel(out, ref) <= TOL[torch.bfloat16]
        with pytest.raises(ValueError):
            ra.attention(*small, causal=True)
        assert fa.launches == before + 1, mode


def test_serving_runs_every_layer_through_the_kernel(card, monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    cfg = tfm.TransformerConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, head_dim=64,
                                d_ff=512, max_seq=256)
    model = tfm.init_params(cfg, seed=0)
    assert model.embed.device == card

    def forward_fn(params, tokens):
        hidden, _ = tfm.forward(cfg, params, tokens)
        return tfm.logits_fn(cfg, params, hidden[:, -1:])[:, -1]

    env = {"HOROVOD_SERVING_MAX_BATCH": "4",
           "HOROVOD_SERVING_LATENCY_BUDGET_MS": "200",
           "HOROVOD_SERVING_MAX_WORKERS": "1"}
    fa.launches = 0
    fe = serving.ServingFrontend(forward_fn, (256,), "int32", env=env,
                                 autoscale=False, params=model)
    try:
        deadline = time.monotonic() + 120
        while fe.stats()["compiles"] < 3:
            assert not fe.stats()["worker_failures"]
            assert time.monotonic() < deadline
            time.sleep(0.01)
        rng = np.random.RandomState(0)
        futs = [fe.submit(rng.randint(0, 512, 256)) for _ in range(6)]
        rows = [f.result(timeout=120) for f in futs]
        s = fe.stats()
    finally:
        fe.close()
    assert s["completed"] == 6 and s["failed"] == 0
    assert s["compiles"] == 3 and not s["worker_failures"]
    assert fa.launches == cfg.n_layers * (3 + s["batches"])
    assert all(np.isfinite(r).all() and r.shape == (512,) for r in rows)


def _bwd_inputs(card, shape, dtype, seed=0):
    q, k, v = _qkv(card, shape, dtype, seed)
    gen = torch.Generator(device=card).manual_seed(seed + 100)
    do = torch.randn(shape, generator=gen, device=card).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_backward_kernels_match_plain(card, D, causal, dtype):
    q, k, v, do = _bwd_inputs(card, (2, 256, 3, D), dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    before = (fa.launches_dkv, fa.launches_dq)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.launches_dkv, fa.launches_dq) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert all(g.dtype == dtype and g.shape == q.shape for g in got)
    assert chip_smoke.grads_rel_err(got, ref) <= chip_smoke.TOL_SLICE[dtype]


def test_backward_reads_strided_inputs_in_place(card):
    """q, k, v as views of one packed (B, L, 3, H, D) projection, and a
    strided dO."""
    qkv = torch.randn((2, 256, 3, 4, 128), device=card).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn((2, 256, 4, 256), device=card).to(
        torch.bfloat16)[..., 64:192]
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert chip_smoke.grads_rel_err(got, ref) <= \
        chip_smoke.TOL_SLICE[torch.bfloat16]


def test_backward_unsupported_inputs_raise_before_launch(card):
    q, k, v, do = _bwd_inputs(card, (1, 128, 2, 288), torch.bfloat16)
    o = torch.zeros_like(q)
    lse = torch.zeros((1, 2, 128), device=card)
    before = (fa.launches_dkv, fa.launches_dq)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, do)
    q, k, v, do = _bwd_inputs(card, (1, 128, 2, 64), torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, do.float())
    assert (fa.launches_dkv, fa.launches_dq) == before


@pytest.mark.parametrize("L,D,causal", [(512, 128, True),
                                         (1000, 128, False),
                                         (2047, 128, True),
                                         (1000, 64, False),
                                         (1000, 256, True)])
def test_backward_is_bitwise_repeatable(card, L, D, causal):
    """Both backward kernels, ragged lengths and non-causal included."""
    q, k, v, do = _bwd_inputs(card, (2, L, 4, D), torch.bfloat16, seed=L)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# ---------------------------------------------------------------------------
# The dK/dV kernel (wgmma, TMA query ring): 64 keys a CTA, query tiles of
# 128 rows at D = 64, 64 at D = 128 and 32 at D = 256, one instantiation
# for any L.

def _kernel_and_plain(kernel, q, k, v, do, causal):
    """What one backward kernel ("dkv": (dk, dv); "dq": dq) returns alone,
    and the plain backward's (dq, dk, dv)."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    di = fa.backward_di(o, do)
    before = getattr(fa, f"launches_{kernel}")
    got = getattr(fa, f"flash_attention_bwd_{kernel}")(
        q, k, v, do, lse, di, causal, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert getattr(fa, f"launches_{kernel}") == before + 1
    return got, fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,L", [(128, 1), (128, 63), (128, 64),
                                 (128, 65), (128, 127), (128, 129),
                                 (128, 2047), (64, 1), (64, 65),
                                 (64, 127), (64, 129), (64, 2047),
                                 (256, 1), (256, 31),
                                 (256, 33), (256, 65), (256, 1000)])
def test_dkv_kernel_at_lengths_around_its_tiles(card, D, L, causal):
    q, k, v, do = _bwd_inputs(card, (2, L, 2, D), torch.bfloat16, seed=L)
    (dk, dv), (_, dk_ref, dv_ref) = _kernel_and_plain("dkv", q, k, v, do,
                                                      causal)
    assert all(g.shape == q.shape and g.is_contiguous() for g in (dk, dv))
    tol = chip_smoke.TOL_SLICE[torch.bfloat16]
    assert chip_smoke.slice_rel_err(dv, dv_ref) <= tol
    if L == 1:
        # One key: a softmax over one score has no gradient, so dK is 0
        # and both sides hold only the float32 rounding of dP - di.
        dv_max = float(dv.float().abs().max())
        assert float(dk.float().abs().max()) <= 1e-4 * dv_max
        assert float(dk_ref.float().abs().max()) <= 1e-4 * dv_max
    else:
        assert chip_smoke.slice_rel_err(dk, dk_ref) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [16, 80, 192])
def test_dkv_kernel_through_the_head_dim_pad(card, D, dtype):
    q, k, v, do = _bwd_inputs(card, (1, 1000, 3, D), dtype, seed=D)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert chip_smoke.grads_rel_err(got, ref) <= chip_smoke.TOL_SLICE[dtype]


# ---------------------------------------------------------------------------
# Either backward kernel alone.

def _kernel_grads(kernel, got, ref):
    """The kernel's outputs and the slice of the plain (dq, dk, dv) they
    are held against, as matching tuples."""
    return ((got,), ref[:1]) if kernel == "dq" else (got, ref[1:])


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_backward_kernel_in_float16(card, D, causal, kernel):
    q, k, v, do = _bwd_inputs(card, (2, 700, 2, D), torch.float16, seed=D)
    got, ref = _kernel_grads(kernel, *_kernel_and_plain(kernel, q, k, v, do,
                                                        causal))
    assert chip_smoke.grads_rel_err(got, ref) <= \
        chip_smoke.TOL_SLICE[torch.float16]


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_backward_kernel_reads_strided_and_head_major_views_in_place(
        card, kernel):
    """q and k as views of one packed (B, L, 3, H, D) projection, v and
    dO as (B, L, H, D) views of (B, H, L, D) tensors: each gets its own
    tensor map in its own strides."""
    qkv = torch.randn((2, 300, 3, 4, 128), device=card).to(torch.bfloat16)
    q, k, _ = qkv.unbind(2)
    v, do = (t.transpose(1, 2) for t in
             _qkv(card, (2, 4, 300, 128), torch.bfloat16, seed=7)[:2])
    assert not q.is_contiguous() and v.stride(2) > v.stride(1)
    got, ref = _kernel_grads(kernel, *_kernel_and_plain(kernel, q, k, v, do,
                                                        True))
    assert chip_smoke.grads_rel_err(got, ref) <= \
        chip_smoke.TOL_SLICE[torch.bfloat16]


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_backward_tensor_map_failure_raises_before_any_output(card, kernel):
    """A view the kernels read but TMA cannot map (a batch stride of
    2^40 elements, past TMA's 2^40-byte limit, on a batch of one): the
    kernel's launch alone, and the whole backward, report the failed
    encode and no kernel runs."""
    q, k, v, do = _bwd_inputs(card, (1, 128, 2, 64), torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    di = fa.backward_di(o, do)
    far = do.as_strided(do.shape, (2 ** 40, *do.stride()[1:]))
    assert torch.equal(far, do)
    before = (fa.launches_dkv, fa.launches_dq)
    with pytest.raises(RuntimeError, match=rf"hvd_flash_attention_bwd_{kernel}"
                                           r": tensor-map encode failed with "
                                           r"CUresult \d+ \(strides .*"
                                           r"1099511627776"):
        getattr(fa, f"flash_attention_bwd_{kernel}")(
            q, k, v, far, lse, di, True, 64 ** -0.5)
    with pytest.raises(RuntimeError, match=r"tensor-map encode failed"):
        fa.flash_attention_bwd(q, k, v, o, lse, far, True)
    assert (fa.launches_dkv, fa.launches_dq) == before


@pytest.fixture(scope="module")
def bwd_ptxas(tmp_path_factory):
    """ptxas's report for every kernel of the backward source, built once
    for the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    from horovod_tpu_torch.ops import _cuda_build as cb
    out = subprocess.run(
        [cb._nvcc(), "-Xptxas=-v", *cb.NVCC_FLAGS, "-o",
         str(tmp_path_factory.mktemp("bwd") / "bwd.so"),
         cb.source_path("flash_attention_bwd")],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return cb.ptxas_resources(out.stdout + out.stderr)


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_backward_kernel_builds_with_no_spills(card, bwd_ptxas, kernel):
    """ptxas's report for every 16-bit instantiation of the kernel: 12
    (bf16, f16 x D = 64, 128, 256 x causal or not), all of them the wgmma
    kernel and none a ragged variant, and no spills at D = 64 and 128."""
    found = [r for r in bwd_ptxas if f"flash_bwd_{kernel}" in r["kernel"]
             and "f32" not in r["kernel"]]
    assert len(found) == 12, [r["kernel"] for r in found]
    for r in found:
        assert f"flash_bwd_{kernel}_wgmma" in r["kernel"], r
        if "256" not in r["kernel"]:
            assert (r["spill_stores"], r["spill_loads"]) == (0, 0), r


# ---------------------------------------------------------------------------
# The dQ kernel (wgmma, TMA K/V ring): 128 query rows a CTA in two
# consumer warpgroups (64 at D = 256, one consumer), key tiles of 64, one
# instantiation for any L.

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,L", [(128, 1), (128, 63), (128, 64),
                                 (128, 65), (128, 127), (128, 128),
                                 (128, 129), (128, 2047), (64, 1),
                                 (64, 65), (64, 129), (64, 2047),
                                 (256, 1), (256, 63), (256, 65),
                                 (256, 1000)])
def test_dq_kernel_at_lengths_around_its_tiles(card, D, L, causal):
    q, k, v, do = _bwd_inputs(card, (2, L, 2, D), torch.bfloat16, seed=L)
    dq, (dq_ref, _, dv_ref) = _kernel_and_plain("dq", q, k, v, do, causal)
    assert dq.shape == q.shape and dq.is_contiguous()
    if L == 1:
        # One key: a softmax over one score has no gradient, so dQ is 0
        # and both sides hold only the float32 rounding of dP - di.
        dv_max = float(dv_ref.float().abs().max())
        assert float(dq.float().abs().max()) <= 1e-4 * dv_max
        assert float(dq_ref.float().abs().max()) <= 1e-4 * dv_max
    else:
        assert chip_smoke.slice_rel_err(dq, dq_ref) <= \
            chip_smoke.TOL_SLICE[torch.bfloat16]


def _small_cfg(**kw):
    return tfm.TransformerConfig(vocab=512, d_model=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, head_dim=64,
                                 d_ff=512, max_seq=256, **kw)


def _batch(card, cfg, seed=0):
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, (2, 256))).to(card)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}


def test_wq_gets_the_plain_paths_gradient_on_the_card(card):
    cfg = _small_cfg()
    model = tfm.init_params(cfg, seed=0)
    batch = _batch(card, cfg)

    def grads():
        model.zero_grad(set_to_none=True)
        tfm.loss_fn(cfg, model, batch).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    with chip_smoke.plain_attention(fa):
        ref = grads()
    before = (fa.launches, fa.launches_dkv, fa.launches_dq)
    got = grads()
    assert (fa.launches, fa.launches_dkv, fa.launches_dq) == tuple(
        b + cfg.n_layers for b in before)
    for name in ("wq", "wk", "wv", "attn_norm"):
        for i in range(cfg.n_layers):
            key = f"layers.{i}.{name}"
            assert float(got[key].float().norm()) > 0, key
    for name in got:
        assert chip_smoke.rel_err(got[name], ref[name]) <= \
            chip_smoke.TOL_GRAD, name


@pytest.mark.parametrize("mode,fwd_per_layer", [("full", 2),
                                                 ("mlp_only", 1)])
def test_remat_launches(card, mode, fwd_per_layer):
    cfg = _small_cfg(remat=True, remat_mode=mode)
    model = tfm.init_params(cfg, seed=0)
    batch = _batch(card, cfg)
    before = (fa.launches, fa.launches_dkv, fa.launches_dq)
    tfm.loss_fn(cfg, model, batch).backward()
    torch.cuda.synchronize()
    after = (fa.launches, fa.launches_dkv, fa.launches_dq)
    assert tuple(a - b for a, b in zip(after, before)) == (
        fwd_per_layer * cfg.n_layers, cfg.n_layers, cfg.n_layers)


def test_one_training_step_through_the_kernels(card):
    cfg = _small_cfg()
    model = tfm.init_params(cfg, seed=0)
    before_params = [p.detach().clone() for p in model.parameters()]
    step = train.build_train_step(lambda m, b: tfm.loss_fn(cfg, m, b),
                                  train.adamw(model.parameters(), 3e-4))
    before = (fa.launches, fa.launches_dkv, fa.launches_dq)
    metrics = step(model, _batch(card, cfg))
    loss = float(metrics["loss"])
    assert metrics["loss"].device == card and np.isfinite(loss)
    assert (fa.launches, fa.launches_dkv, fa.launches_dq) == tuple(
        b + cfg.n_layers for b in before)
    assert all(not torch.equal(p, b)
               for p, b in zip(model.parameters(), before_params))


# ---------------------------------------------------------------------------
# Ragged lengths and float16 (the flash kernels mask a ragged last tile).

@pytest.mark.parametrize("L,dtype,causal", [
    (16, torch.bfloat16, True), (1000, torch.bfloat16, True),
    (2047, torch.bfloat16, False), (100, torch.bfloat16, False),
    (1000, torch.float16, True), (2048, torch.float16, True),
    (1000, torch.float32, False)])
def test_kernels_take_ragged_lengths_and_float16(card, L, dtype, causal):
    q, k, v, do = _bwd_inputs(card, (1, L, 4, 128), dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert _rel(o, o_ref) <= chip_smoke.TOL_ROW[dtype]
    assert _abs(lse, lse_ref) <= TOL_LSE
    assert chip_smoke.grads_rel_err(got, ref) <= chip_smoke.TOL_SLICE[dtype]


def test_serving_length_ladder_on_the_card(card):
    """HOROVOD_SERVING_MAX_LEN=64: rungs 16, 32 and 64 warm up and
    answer through the kernel."""
    cfg = tfm.TransformerConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, head_dim=64,
                                d_ff=512, max_seq=64)
    model = tfm.init_params(cfg, seed=0)

    def forward_fn(params, tokens):
        hidden, _ = tfm.forward(cfg, params, tokens)
        return tfm.logits_fn(cfg, params, hidden)

    env = {"HOROVOD_SERVING_MAX_BATCH": "2",
           "HOROVOD_SERVING_MAX_LEN": "64",
           "HOROVOD_SERVING_LATENCY_BUDGET_MS": "20",
           "HOROVOD_SERVING_MAX_WORKERS": "1"}
    fa.launches = 0
    fe = serving.ServingFrontend(forward_fn, (), "int32", env=env,
                                 autoscale=False, params=model)
    try:
        rng = np.random.RandomState(1)
        futs = [fe.submit(rng.randint(0, 512, n)) for n in (10, 30, 50)]
        rows = [f.result(timeout=120) for f in futs]
        s = fe.stats()
    finally:
        fe.close()
    assert s["completed"] == 3 and s["failed"] == 0
    assert s["compiles"] == 6 and not s["worker_failures"]
    assert [r.shape for r in rows] == [(10, 512), (30, 512), (50, 512)]
    assert fa.launches == cfg.n_layers * (6 + s["batches"])


# ---------------------------------------------------------------------------
# The tied LM head's mixed product (aten::mm.dtype) on the card.

def test_tied_head_matches_the_float32_product(card):
    gen = torch.Generator(device=card).manual_seed(3)
    h = torch.randn((2, 256, 512), generator=gen, device=card).to(
        torch.bfloat16).requires_grad_()
    e = torch.randn((1000, 512), generator=gen, device=card).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn((2, 256, 1000), generator=gen, device=card)
    cfg = tfm.TransformerConfig(vocab=1000, d_model=512)
    params = type("P", (), {"embed": e})()
    got = tfm.logits_fn(cfg, params, h)
    got.backward(g)
    dh, de = h.grad.clone(), e.grad.clone()
    h.grad = e.grad = None
    want = chip_smoke.f32_lm_head(cfg, params, h)
    want.backward(g)
    assert got.dtype == torch.float32
    assert chip_smoke.rel_err(got, want) <= 1e-5
    assert chip_smoke.rel_err(dh, h.grad) <= \
        chip_smoke.TOL_COMBINE[torch.bfloat16]
    assert chip_smoke.rel_err(de, e.grad) <= \
        chip_smoke.TOL_COMBINE[torch.bfloat16]


# ---------------------------------------------------------------------------
# Adasum K1/K2 against their plain versions (phase 8's cases, smaller),
# and a two-rank gloo fold on the card.

@pytest.mark.parametrize("n", [1, 1000, 2 ** 20 + 7])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
def test_adasum_kernels_match_plain(card, n, dtype):
    a, b = chip_smoke.adasum_inputs(card, n, dtype, seed=n)
    before = (ak.launches_partials, ak.launches_scaled_add)
    stats = ak.adasum_partials(a, b)
    out = ak.adasum_scaled_add(stats, a, b)
    again = ak.adasum_pair_combine(a, b)
    torch.cuda.synchronize()
    assert (ak.launches_partials, ak.launches_scaled_add) == tuple(
        x + 2 for x in before)
    ref = ak.adasum_pair_combine_plain(a, b)
    errs = chip_smoke.adasum_errors(stats, out, a, b, ref)
    assert chip_smoke.adasum_check_ratio(errs, dtype) <= 1, errs
    assert torch.equal(out, again)
    # With the same coefficients K2 is the plain scaled add, bitwise.
    assert torch.equal(out, ak.adasum_scaled_add_plain(stats, a, b))


@pytest.mark.parametrize("kind", ["zero", "orthogonal", "opposite"])
def test_adasum_kernels_special_cases(card, kind):
    a, b = chip_smoke.adasum_inputs(card, 4096, torch.float16, 0, kind)
    out = ak.adasum_pair_combine(a, b)
    if kind == "opposite":
        assert float(out.float().abs().max()) == 0.0
    else:
        assert torch.equal(out, a + b)


def test_adasum_kernels_take_unaligned_views_and_write_into_a(card):
    a, b = chip_smoke.adasum_inputs(card, 4099, torch.bfloat16, 1)
    a1, b1 = a[1:], b[1:]                   # 2 bytes off the 16-byte grid
    got = ak.adasum_pair_combine(a1, b1)
    ref = ak.adasum_pair_combine_plain(a1, b1)
    assert chip_smoke.rel_err(got, ref) <= \
        chip_smoke.TOL_COMBINE[torch.bfloat16]
    want = ak.adasum_pair_combine(a, b)
    out = ak.adasum_pair_combine(a, b, out=a)
    assert out is a and torch.equal(a, want)


def _gloo_adasum_rank(rank, store, results):
    import datetime
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        hvd.init(config_overrides={"HOROVOD_ADASUM_PALLAS": "1"})
        x = chip_smoke.adasum_inputs(torch.device("cuda", 0), 2 ** 20 + 7,
                                     torch.float32, seed=rank)[0]
        out = hvd.allreduce(x, op=hvd.Adasum,
                            compression=hvd.Compression.fp16)
        # numpy, not a tensor: a tensor travels as shared memory that
        # dies with this process.
        results.put((rank, "ok", (out.cpu().numpy(), ak.launches_partials,
                                  ak.launches_scaled_add)))
        hvd.shutdown()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        results.put((rank, "error", traceback.format_exc()))


def test_two_rank_gloo_adasum_fold_on_the_card(card, tmp_path):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_gloo_adasum_rank,
                         args=(r, str(tmp_path / "store"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict((r, (s, v)) for r, s, v in
                   (results.get(timeout=120) for _ in range(2)))
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    assert all(s == "ok" for s, _ in got.values()), got
    (out0, k1, k2), (out1, _, _) = got[0][1], got[1][1]
    assert (k1, k2) == (1, 1)
    np.testing.assert_array_equal(out0, out1)
    xs = [chip_smoke.adasum_inputs(card, 2 ** 20 + 7, torch.float32,
                                   seed=r)[0].half() for r in range(2)]
    ref = ak.adasum_pair_combine_plain(*xs).float().cpu()
    assert chip_smoke.rel_err(torch.from_numpy(out0), ref) <= \
        chip_smoke.TOL_COMBINE[torch.float16]


def _gloo_vhdd_rank(rank, store, results, size, dtypes):
    """One rank of a gloo world on the card under default knobs: each
    dtype's vhdd Adasum (K1/K2) and, on the same CUDA tensors, the
    schedule's plain branch."""
    import datetime
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import adasum as adasum_mod
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=60))
        hvd.init()
        out = {}
        for i, dtype in enumerate(dtypes):
            x = chip_smoke.coll_contribution(torch.device("cuda", 0),
                                             (2 ** 20 + 7,), dtype, i, rank)
            ak.launches_partials = ak.launches_scaled_add = 0
            got = hvd.allreduce(x, op=hvd.Adasum)
            launches = (ak.launches_partials, ak.launches_scaled_add)
            pad = (-x.numel()) % adasum_mod._pow2_blocks(size)[0][1]
            seg = torch.cat([x, x.new_zeros(pad)])
            plain = adasum_mod.vhdd(
                seg, rank, size,
                adasum_mod._DistWire(hvd.global_process_set()),
                use_kernel=False)[:x.numel()]
            # numpy, not tensors: a tensor travels as shared memory that
            # dies with this process.
            out[str(dtype)] = (got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), launches,
                               (ak.launches_partials,
                                ak.launches_scaled_add))
        results.put((rank, "ok", out))
        hvd.shutdown()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        results.put((rank, "error", traceback.format_exc()))


@pytest.mark.parametrize("size", [2, 3])
def test_gloo_vhdd_kernels_match_the_plain_branch_on_the_card(card, size,
                                                              tmp_path):
    """vhdd under default knobs launches K1 and K2 once per halving
    level and once per merge on each rank (n = 2: one level; n = 3:
    ranks 0 and 1 a level and the merge, rank 2 the merge), and agrees
    with the schedule's plain branch on the same tensors and with the
    float64 ``adasum_reference`` within the non-power-of-two fold's two
    roundings (chip_smoke.TOL_FOLD3); ranks agree bitwise. The
    contributions share a part (``chip_smoke.coll_contribution``), so a
    plain sum misses the reference by more than COLL_SEPARATION times
    that tolerance. The plain branch launches nothing."""
    import multiprocessing as mp
    dtypes = [torch.float16, torch.bfloat16, torch.float32]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_gloo_vhdd_rank,
                         args=(r, str(tmp_path / "store"), results, size,
                               dtypes))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        got = dict((r, (s, v)) for r, s, v in
                   (results.get(timeout=180) for _ in range(size)))
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    assert all(s == "ok" for s, _ in got.values()), got
    want = {2: [(1, 1)] * 2, 3: [(2, 2), (2, 2), (1, 1)]}[size]
    for dtype in dtypes:
        outs = [got[r][1][str(dtype)] for r in range(size)]
        for r, (kern, plain, launches, after) in enumerate(outs):
            np.testing.assert_array_equal(kern, outs[0][0])
            assert launches == want[r] and after == launches, (r, launches)
            assert chip_smoke.rel_err(torch.from_numpy(kern),
                                      torch.from_numpy(plain)) <= \
                chip_smoke.TOL_FOLD3[dtype]
        xs = [chip_smoke.coll_contribution(card, (2 ** 20 + 7,), dtype,
                                           dtypes.index(dtype), r)
              .double().cpu().numpy() for r in range(size)]
        ref = adasum_reference(xs)
        tol = chip_smoke.TOL_FOLD3[dtype]
        assert chip_smoke._norm_rel(outs[0][0].astype(np.float64),
                                    ref) <= tol
        assert chip_smoke.adasum_gaps(xs, ref)["plain_sum_gap"] > \
            chip_smoke.COLL_SEPARATION * tol


@pytest.mark.parametrize("shape,dtype", [((4096, 11008), torch.bfloat16),
                                         ((11008, 4096), torch.float32),
                                         ((300, 7), torch.float32)])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_powersgd_round_on_the_card(card, n, shape, dtype):
    """PowerSGD's arithmetic on the card (the stages of
    ``powersgd_reduce``, n ranks' factors summed here) against the same
    round in float64 on the host: the reduced matrix and each rank's
    residual within chip_smoke's TOL_PSGD, and a plain sum or an
    unorthogonalized P missing it by FAULT_MARGIN times that."""
    from horovod_tpu_torch.ops import compression as comp
    gen = torch.Generator(device=card).manual_seed(n)
    mats = [torch.randn(shape, generator=gen, device=card).to(dtype)
            for _ in range(n)]
    q = comp.init_q(shape, 4, 0, card)
    es = [torch.zeros(shape, device=card) for _ in range(n)]
    staged = [comp.powersgd_compress([m], [q], [e])
              for m, e in zip(mats, es)]
    red_p = sum(comp.powersgd_pack(ps) for _, ps in staged)
    proj = [comp.powersgd_project(ms, ps, red_p) for ms, ps in staged]
    red_q = sum(comp.powersgd_pack(qns) for _, qns in proj)
    host = [m.float().cpu().numpy() for m in mats]
    ref, wrong = chip_smoke.powersgd_round_f64(host, q.cpu().numpy())
    tol = chip_smoke.TOL_PSGD
    for r in range(n):
        outs, new_qs, new_es = comp.powersgd_decompress(
            staged[r][0], proj[r][0], proj[r][1], red_q, n)
        assert outs[0].is_cuda and new_es[0].dtype == torch.float32
        assert chip_smoke._rel64(outs[0].cpu().numpy(), ref) <= tol
        assert chip_smoke._rel64(new_es[0].cpu().numpy(),
                                 host[r] - ref / n) <= tol
    for name, w in wrong.items():
        assert chip_smoke._rel64(w, ref) > chip_smoke.FAULT_MARGIN * tol, \
            name
