"""chip_smoke.py's checks, on the CPU: its kernel-vs-plain measures
(the forward's worst row, the backward's worst (b, h) slice) admit the
bf16 rounding an honest flash kernel does and reject the faults it
plants (the backward's by 10x its tolerance), and without a CUDA device
it exits non-zero with no result.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa

SHAPE = (2, 256, 2, 64)


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*SHAPE).astype(np.float32))
            .to(torch.bfloat16) for _ in range(3)]


def _bf16_p_attention(q, k, v, causal):
    """Attention that rounds the unnormalised P to bf16 before P V and
    o to bf16, as the kernel does."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * \
        q.shape[-1] ** -0.5
    if causal:
        L = q.shape[1]
        s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                     v.float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_row_check_admits_bf16_rounding(causal):
    q, k, v = _qkv()
    ref = fa.flash_attention_fwd_plain(q, k, v, causal)[0]
    err = chip_smoke.row_rel_err(_bf16_p_attention(q, k, v, causal), ref)
    assert err <= chip_smoke.TOL_ROW[torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False])
def test_row_check_rejects_planted_faults(causal):
    q, k, v = _qkv(seed=1)
    ref = fa.flash_attention_fwd_plain(q, k, v, causal)[0]
    faults = chip_smoke.planted_faults(fa, q, k, v, causal)
    assert set(faults) == {"no_rescale", "v_first_tile"}
    for name, bad in faults.items():
        assert bad.shape == ref.shape and bad.dtype == ref.dtype
        assert chip_smoke.row_rel_err(bad, ref) > \
            chip_smoke.TOL_ROW[torch.bfloat16], name


def test_row_rel_err_is_per_row():
    ref = torch.tensor([[100.0, 0.0], [0.0, 1.0]])
    got = ref.clone()
    got[1, 1] = 1.5                          # small next to max |ref|
    assert chip_smoke.row_rel_err(got, ref) == pytest.approx(0.5)


def test_no_cuda_exits_nonzero_without_result(capsys):
    assert not torch.cuda.is_available()
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def _bf16_backward(q, k, v, o, lse, do, causal):
    """The backward as the kernels round it: P and dS to bf16 before
    their products, the gradients to bf16."""
    r = lambda x: x.to(torch.bfloat16).float()   # noqa: E731
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        L = q.shape[1]
        s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", r(p), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = r(p * (dp - fa.backward_di(o, do)[..., None]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _bwd_case(causal, seed):
    q, k, v = _qkv(seed)
    do = _qkv(seed + 10)[0]
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    return (q, k, v, o, lse, do), fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_slice_check_admits_bf16_backward_rounding(causal):
    args, ref = _bwd_case(causal, seed=2)
    err = chip_smoke.grads_rel_err(_bf16_backward(*args, causal), ref)
    assert err <= chip_smoke.TOL_SLICE[torch.bfloat16]


def test_slice_check_rejects_planted_backward_faults():
    args, ref = _bwd_case(True, seed=3)
    faults = chip_smoke.planted_backward_faults(*args, True)
    assert set(faults) == {"no_di", "no_causal_mask", "dk_unscaled"}
    for name, bad in faults.items():
        assert all(b.shape == r.shape and b.dtype == r.dtype
                   for b, r in zip(bad, ref))
        assert chip_smoke.grads_rel_err(bad, ref) >= \
            chip_smoke.FAULT_MARGIN * chip_smoke.TOL_SLICE[torch.bfloat16], \
            name


def test_slice_rel_err_is_per_slice():
    ref = torch.ones(1, 4, 2, 8)
    ref[:, :, 1] *= 100.0
    got = ref.clone()
    got[:, :, 0] *= 1.5                       # small next to max |ref|
    assert chip_smoke.slice_rel_err(got, ref) == pytest.approx(0.5)
    assert chip_smoke.rel_err(got, ref) < 0.01
