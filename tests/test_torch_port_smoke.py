"""chip_smoke.py's checks, on the CPU: its kernel-vs-plain measures
(the forward's worst row, the backward's worst (b, h) slice) admit the
bf16 rounding an honest flash kernel does and reject the faults it
plants by 10x their tolerance; its Adasum check admits
the plain version and rejects both planted faults by 10x; phase 9's two
ranks rehearse on gloo and the CPU at a small size; and without a CUDA
device it exits non-zero with no result.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import adasum_kernels as ak
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
        assert chip_smoke.row_rel_err(bad, ref) >= \
            chip_smoke.FAULT_MARGIN * chip_smoke.TOL_ROW[torch.bfloat16], \
            name


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
    assert set(faults) == {"no_di", "no_causal_mask", "dk_unscaled",
                           "ring_first_tile"}
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


# Adasum (phases 8 and 9).

def _adasum_pair(n, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    a = rng.randn(n).astype(np.float32)
    b = (0.3 * a + rng.randn(n)).astype(np.float32)
    return torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_adasum_check_admits_the_plain_version(dtype):
    a, b = _adasum_pair(3 * chip_smoke.FAULT_BLOCK + 5, seed=1, dtype=dtype)
    ref = ak.adasum_pair_combine_plain(a, b)
    errs = chip_smoke.adasum_errors(ak.adasum_partials_plain(a, b), ref,
                                    a, b, ref)
    assert chip_smoke.adasum_check_ratio(errs, dtype) <= 0.1, errs


def test_adasum_check_rejects_planted_faults():
    a, b = _adasum_pair(40 * chip_smoke.FAULT_BLOCK, seed=2)
    ref = ak.adasum_pair_combine_plain(a, b)
    faults = chip_smoke.planted_adasum_faults(ak, a, b)
    assert set(faults) == {"k1_tail_block_dropped", "k2_ca_for_both"}
    for name, (stats, out) in faults.items():
        ratio = chip_smoke.adasum_check_ratio(
            chip_smoke.adasum_errors(stats, out, a, b, ref), torch.float32)
        assert ratio >= chip_smoke.FAULT_MARGIN, (name, ratio)


def test_adasum_bound_is_bytes():
    ms, by = chip_smoke.adasum_bound(4096 * 11008, torch.float16, "k1")
    assert by == "bytes" and ms == pytest.approx(
        1e3 * 2 * 4096 * 11008 * 2 / chip_smoke.PEAK_BYTES)
    ms, by = chip_smoke.adasum_bound(32000 * 4096, torch.float16, "k2")
    assert by == "bytes" and ms == pytest.approx(
        1e3 * 3 * 32000 * 4096 * 2 / chip_smoke.PEAK_BYTES)


def test_phase_9_rehearses_on_the_cpu():
    """Phase 9's two ranks at a small size on gloo and the CPU: the
    broadcast and every step leave the ranks bitwise equal, and the
    reduced FFN gradient matches the plain fold (no launches: the CPU
    runs the plain versions)."""
    ranks = chip_smoke.phase_adasum_training(
        device="cpu", cfg_kw=dict(vocab=128, d_model=32, n_layers=2,
                                  n_heads=2, n_kv_heads=2, head_dim=16,
                                  d_ff=64, max_seq=32), seq=32, timeout=90)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" and r["launches"] == (0, 0)
               and r["n_grad_tensors"] == 20 for r in ranks)
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert len(ranks[0]["steps"]) == chip_smoke.DP_STEPS


SMALL_DP = dict(vocab=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
                head_dim=16, d_ff=64, max_seq=32)


def test_phase_9_routes_agree_on_the_cpu():
    """Phase 9's vhdd run (default knobs) and its gather-route run
    (HOROVOD_ADASUM_PALLAS=1, DP_GATHER_STEPS steps) at a small size on
    gloo and the CPU: each keeps its ranks bitwise equal, and step 0's
    reduced FFN gradient of one route is within phase 8's fp16
    tolerance of the other's."""
    vhdd = chip_smoke.phase_adasum_training(device="cpu", cfg_kw=SMALL_DP,
                                            seq=32, timeout=90)
    gather = chip_smoke.phase_adasum_training(
        device="cpu", cfg_kw=SMALL_DP, seq=32, timeout=90, route="gather",
        steps=chip_smoke.DP_GATHER_STEPS)
    assert [r["route"] for r in vhdd + gather] == ["vhdd"] * 2 + \
        ["gather"] * 2
    assert len(gather[0]["steps"]) == chip_smoke.DP_GATHER_STEPS
    assert gather[0]["digests"] == gather[1]["digests"]
    # The same weights and batches: step 0 starts from the same point.
    assert gather[0]["digests"][0] == vhdd[0]["digests"][0]
    assert 0 < chip_smoke.routes_rel_err(vhdd, gather) <= \
        chip_smoke.TOL_COMBINE[torch.float16]


def test_phase_10_rehearses_on_the_cpu():
    """Phase 10's three ranks at a small size on gloo and the CPU: every
    collective's check passes where it ran, vhdd's result is within
    TOL_FOLD3 of the float64 reference and bitwise equal on the three
    ranks, a plain sum or an unprojected merge would miss it by more
    than COLL_SEPARATION times that, and the non-member refuses the set
    (no launches: the CPU runs the plain branch)."""
    ranks = chip_smoke.phase_collectives(
        device="cpu", sizes={"adasum": ((64, 48), (40, 33)), "width": 16,
                             "rows": 10, "pair_adasum": (64, 48)},
        timeout=120)
    assert [r["rank"] for r in ranks] == [0, 1, 2]
    assert len(ranks[0]["adasum"]) == 6
    for c in ranks[0]["adasum"]:
        tol = chip_smoke.TOL_FOLD3[getattr(torch, c["dtype"])]
        assert c["rel_err"] <= tol
        assert min(c["plain_sum_gap"], c["unprojected_merge_gap"]) > \
            chip_smoke.COLL_SEPARATION * tol
    assert ranks[1]["cases"]["set refuses a non-member"]["ok"]
    assert {"allgather", "alltoall", "reducescatter", "min", "max",
            "product", "grouped_allgather", "grouped_reducescatter",
            "allgather_object", "barrier", "set allreduce",
            "set adasum float16", "set adasum float32"} <= set(
                ranks[0]["cases"])


def test_phase_11_rehearses_on_the_cpu(monkeypatch):
    """Phase 11 at a small size on gloo and the CPU: the world of one
    (gloo here, NCCL on the card) has no bucket and the mesh changes
    nothing; the two ranks follow the plan, stay bitwise equal, skip
    together on rank 1's NaN, name rank 1's flipped bit, and the
    overlap-off step and the fp16 wire pass their gates (no launches:
    the CPU runs the plain versions)."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import mesh as tmesh
    from horovod_tpu_torch.parallel import train as ttrain
    model = tfm.Transformer(tfm.TransformerConfig(**SMALL_DP),
                            torch.device("meta"))
    plan = ttrain.plan_overlap(model, tmesh.Mesh({"data": 2}),
                               overlap_threshold=8000, guard=True)
    assert len(plan.bucket_leaf_indices) > 2
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "8000")  # the ranks'
    res = chip_smoke.phase_dp_step(device="cpu", cfg_kw=SMALL_DP, seq=32,
                                   timeout=120, plan=plan.digest)
    assert res["world1"]["backend"] == "gloo"
    ranks = res["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert all(r["launches"] == {"fwd": 0, "dkv": 0, "dq": 0}
               for r in ranks)
    assert all(r["fp16"]["within"] for r in ranks)


def test_phase_12_rehearses_on_the_cpu():
    """Phase 12 at a small size on gloo and the CPU, under the default
    knobs (the C++ core): out-of-order submission at the host answers
    and a wrong answer inline, DistributedOptimizer negotiated bitwise
    equal to inline, join (rank 0's reduced gradients its own, the
    broadcast refused), two Adasum entries (one agreed batch or two) within
    phase 8's fp16 tolerance, the mismatch and the order check, and the
    world of one on the C++ core bitwise equal to inline (no launches:
    the CPU runs the plain versions)."""
    res = chip_smoke.phase_negotiated(
        device="cpu", cfg_kw=SMALL_DP, seq=32,
        sizes={"ooo_shape": (64, 48), "inline_shape": (64,),
               "adasum_shape": (64, 48)}, timeout=120)
    ranks = res["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["optimizer"]["launches"] == {"fwd": 0, "dkv": 0, "dq": 0}
               for r in ranks)
    assert all(r["adasum"]["launches"] == (0, 0) for r in ranks)
    assert res["out_of_order"]["rank 0"]["inline_distance"] > 0
    assert ranks[0]["join"]["steps"][-1]["local_bitwise"]
    assert res["world1"]["runs"]["native"]["core"] == "NativeCore"


def test_powersgd_gate_admits_the_round_and_rejects_wrong_answers():
    """Phase 13's gate (e): the port's float32 round over two ranks is
    within TOL_PSGD of the float64 round, and a plain sum or an
    unorthogonalized P miss it by FAULT_MARGIN times that."""
    from horovod_tpu_torch.ops import compression as comp
    rs = np.random.RandomState(0)
    mats = [rs.randn(96, 64).astype(np.float32) for _ in range(2)]
    q = comp.init_q((96, 64), chip_smoke.PSGD_RANK, 9, "cpu")
    staged = [comp.powersgd_compress([torch.from_numpy(m)], [q],
                                     [torch.zeros(96, 64)]) for m in mats]
    red_p = sum(comp.powersgd_pack(ps) for _, ps in staged)
    proj = [comp.powersgd_project(ms, ps, red_p) for ms, ps in staged]
    red_q = sum(comp.powersgd_pack(qns) for _, qns in proj)
    out = comp.powersgd_decompress(staged[0][0], proj[0][0], proj[0][1],
                                   red_q, 2)[0][0]
    ref, wrong = chip_smoke.powersgd_round_f64(mats, q.numpy())
    assert chip_smoke._rel64(out.numpy(), ref) <= chip_smoke.TOL_PSGD
    for name, w in wrong.items():
        assert chip_smoke._rel64(w, ref) > \
            chip_smoke.FAULT_MARGIN * chip_smoke.TOL_PSGD, name
    assert chip_smoke._sigma_ratio(out) < chip_smoke.PSGD_LOW_RANK
    assert chip_smoke._sigma_ratio(torch.from_numpy(mats[0] + mats[1])) \
        >= chip_smoke.PSGD_LOW_RANK


def test_powersgd_reckoning_of_the_flagship():
    """Gate (b)'s reckoning from the parameters alone equals the plan's
    wire at Llama-2-7B width, 2 layers: 769,024 factor elements and the
    five float32 norms with the flag riding them; the plan is
    PSGD_PLAN."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import mesh as tmesh
    from horovod_tpu_torch.parallel import train as ttrain
    model = tfm.Transformer(tfm.TransformerConfig(
        **dict(chip_smoke.LLAMA2_7B, n_layers=chip_smoke.DP_LAYERS)),
        torch.device("meta"))
    factors, exact = chip_smoke.psgd_reckoning(
        model, chip_smoke.PSGD_MIN_ELEMENTS)
    assert (factors, exact) == (4 * 769_024, 4 * 5 * 4096 + 4)
    plan = ttrain.plan_overlap(model, tmesh.Mesh({"data": 2}),
                               overlap_threshold=64 << 20, guard=True,
                               compression="powersgd:4")
    assert plan.digest == chip_smoke.PSGD_PLAN
    assert ttrain._wire_bytes(plan) == factors + exact


def test_phase_13_rehearses_on_the_cpu():
    """Phase 13 at a small size on gloo and the CPU (every matrix
    eligible at min_elements=256): both planes pass every gate, the
    probe's float32 round is the float64 one's, the wrong answers miss,
    and the two planes end each step bitwise equal (no launches: the
    CPU runs the plain versions)."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel import mesh as tmesh
    from horovod_tpu_torch.parallel import train as ttrain
    model = tfm.Transformer(tfm.TransformerConfig(**SMALL_DP),
                            torch.device("meta"))
    plan = ttrain.plan_overlap(model, tmesh.Mesh({"data": 2}),
                               overlap_threshold=64 << 20, guard=True,
                               compression="powersgd:4",
                               compression_min_elements=256)
    res = chip_smoke.phase_powersgd(device="cpu", cfg_kw=SMALL_DP, seq=32,
                                    timeout=120, plan=plan.digest,
                                    min_elements=256)
    ranks = res["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["train"]["launches"] == {"fwd": 0, "dkv": 0, "dq": 0}
        assert r["train"]["digests"] == r["optimizer"]["digests"]
        assert r["train"]["steps"][0]["wire_bytes"] == \
            ttrain._wire_bytes(plan)
    assert ranks[0]["train"]["probe_rel_err"] <= 1e-5
