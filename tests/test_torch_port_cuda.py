"""horovod_tpu_torch's CUDA kernels on the card: the flash-attention
forward and its dK/dV and dQ backward kernels against their plain
versions, their launch counters, attention() on CUDA tensors, and the
serving and training paths through the kernels.

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
the reasons it gives.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as tfm
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
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


def test_unsupported_shape_raises_before_launch(card):
    q, k, v = _qkv(card, (1, 128, 2, 32), torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v)
    assert fa.launches == before


def test_attention_modes_on_the_card(card, monkeypatch):
    """CUDA tensors launch the kernel whatever HOROVOD_FLASH_ATTENTION
    says, and a shape the kernel does not take raises."""
    q, k, v = _qkv(card, (1, 256, 2, 64), torch.bfloat16)
    small = _qkv(card, (1, 256, 2, 16), torch.bfloat16)
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
@pytest.mark.parametrize("D", [64, 128, 256])
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
    q, k, v, do = _bwd_inputs(card, (1, 128, 2, 32), torch.bfloat16)
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


def test_backward_is_bitwise_repeatable(card):
    q, k, v, do = _bwd_inputs(card, (2, 512, 4, 128), torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


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
