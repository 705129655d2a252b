"""The Adasum pair combine and fold against the JAX package on the CPU:
K1/K2's plain versions (which the wrappers run for CPU tensors) against
``horovod_tpu/ops/pallas_kernels.py`` ``adasum_pair_combine(...,
interpret=True)`` on the cases of tests/test_pallas_kernels.py, the
port's ``_tree_fold`` against the reference's and ``adasum_reference``,
and the routing knobs (HOROVOD_ADASUM_PALLAS, HOROVOD_ADASUM_MODE)
against the reference's answers.

Tolerances. float32: relative 1e-5 and absolute 1e-6 per element against
the Pallas interpreter (both sum in float32, in other orders; seen: about
1e-7), and the reference test's rtol = atol = 1e-5 against the float64
numpy model. bfloat16 and float16 outputs: one rounding to the dtype
after float32 math on both sides, so a coefficient that differs in its
last float32 bit can move an element by one unit in the last place:
relative 2^-7 (bf16) and 2^-10 (f16) per element against the interpreter;
the reference test's 0.05 against numpy. The fold of n rows compounds
n - 1 combines: relative 1e-5 per element in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops.pallas_kernels import (BLOCK_ROWS, LANES,
                                            adasum_pair_combine)
from horovod_tpu_torch.ops import adasum as tadasum
from horovod_tpu_torch.ops import adasum_kernels as ak
from horovod_tpu_torch.ops.process_set import ProcessSet

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
RTOL_16 = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _np_combine(a, b):
    return jadasum.adasum_reference([np.asarray(a, np.float64),
                                     np.asarray(b, np.float64)])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n", [
    1, 100, LANES * 8, BLOCK_ROWS * LANES, BLOCK_ROWS * LANES + 7,
    3 * BLOCK_ROWS * LANES])
def test_pair_combine_matches_the_pallas_interpreter(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(adasum_pair_combine(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    before = (ak.launches_partials, ak.launches_scaled_add)
    got = ak.adasum_pair_combine(torch.from_numpy(a), torch.from_numpy(b))
    assert (ak.launches_partials, ak.launches_scaled_add) == before
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _np_combine(a, b), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(999).astype(np.float32))
            for _ in range(2))
    stats = ak.adasum_partials(a, b)
    assert torch.equal(stats, ak.adasum_partials_plain(a, b))
    assert stats.shape == (5,) and stats.dtype == torch.float32
    assert torch.equal(ak.adasum_scaled_add(stats, a, b),
                       ak.adasum_scaled_add_plain(stats, a, b))
    assert torch.equal(ak.adasum_pair_combine(a, b),
                       ak.adasum_pair_combine_plain(a, b))
    ad, bd = a.double(), b.double()
    np.testing.assert_allclose(
        stats[2:].numpy(), [float(ad @ bd), float(ad @ ad), float(bd @ bd)],
        rtol=1e-5)


def test_scaled_add_writes_into_a():
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(300).astype(np.float32))
            for _ in range(2))
    want = ak.adasum_pair_combine_plain(a, b)
    out = ak.adasum_pair_combine(a, b, out=a)
    assert out is a and torch.equal(a, want)


def test_pair_combine_shapes_preserved():
    a = torch.ones((4, 33, 7))
    b = torch.full((4, 33, 7), 2.0)
    out = ak.adasum_pair_combine(a, b)
    want = adasum_pair_combine(jnp.ones((4, 33, 7)),
                               jnp.full((4, 33, 7), 2.0), interpret=True)
    assert out.shape == (4, 33, 7) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6)


def test_pair_combine_zero_norm_guard():
    z, v = torch.zeros(256), torch.ones(256)
    out = ak.adasum_pair_combine(z, v)
    want = adasum_pair_combine(jnp.zeros(256), jnp.ones(256), interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_allclose(out.numpy(), np.ones(256), rtol=1e-6)
    both = ak.adasum_partials(z, z)
    assert both[:2].tolist() == [1.0, 1.0]


def test_pair_combine_orthogonal_is_sum_and_opposite_is_zero():
    a = torch.zeros(512)
    b = torch.zeros(512)
    a[:256] = 1.0
    b[256:] = 1.0
    np.testing.assert_allclose(ak.adasum_pair_combine(a, b).numpy(),
                               (a + b).numpy(), rtol=1e-6)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(777)
                         .astype(np.float32))
    assert float(ak.adasum_pair_combine(x, -x).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_inputs_accumulate_in_f32(dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(5000).astype(np.float32)
    ja, jb = jnp.asarray(a, JNP[dtype]), jnp.asarray(b, JNP[dtype])
    want = adasum_pair_combine(ja, jb, interpret=True)
    ta, tb = (torch.from_numpy(_f32(x)).to(TORCH[dtype]) for x in (ja, jb))
    got = ak.adasum_pair_combine(ta, tb)
    assert got.dtype == TORCH[dtype] and want.dtype == JNP[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL_16[dtype],
                               atol=0)
    # The sums are float32 sums of the 16-bit inputs, not 16-bit sums.
    stats = ak.adasum_partials(ta, tb)
    ad, bd = ta.double(), tb.double()
    np.testing.assert_allclose(float(stats[2]), float(ad @ bd), rtol=1e-5)
    np.testing.assert_allclose(_f32(got), _np_combine(a, b), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("bad", ["shape", "dtype", "float64", "device"])
def test_kernel_wrappers_check_their_inputs(bad):
    a = torch.zeros(8)
    b = {"shape": torch.zeros(9), "dtype": torch.zeros(8).half(),
         "float64": None, "device": torch.zeros(8, device="meta")}[bad]
    if bad == "float64":
        a, b = torch.zeros(8).double(), torch.zeros(8).double()
    if bad == "device":
        a = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        ak.adasum_partials(a, b)
    with pytest.raises(ValueError):
        ak.adasum_scaled_add(torch.ones(5), a, b)


@pytest.mark.parametrize("n", range(2, 9))
def test_tree_fold_matches_the_reference(n):
    rng = np.random.RandomState(7 + n)
    xs = rng.randn(n, 37).astype(np.float32)
    rows = [torch.from_numpy(x.copy()) for x in xs]
    want_kernel = np.asarray(jadasum._tree_fold(
        [jnp.asarray(x) for x in xs], use_pallas=True))
    want_plain = np.asarray(jadasum._tree_fold(
        [jnp.asarray(x) for x in xs], use_pallas=False))
    got_kernel = tadasum._tree_fold(rows, use_pallas=True)
    got_plain = tadasum._tree_fold(rows, use_pallas=False)
    for r, x in zip(rows, xs):
        np.testing.assert_array_equal(r.numpy(), x)   # rows not written
    np.testing.assert_allclose(got_kernel.numpy(), want_kernel, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_plain.numpy(), want_plain, rtol=1e-5,
                               atol=1e-6)
    oracle = jadasum.adasum_reference(list(xs))
    np.testing.assert_allclose(got_kernel.numpy(), oracle, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64])
def test_non_kernel_branch_takes_float64_and_complex(dtype):
    rng = np.random.RandomState(1)
    xs = [rng.randn(16) for _ in range(3)]
    if dtype == torch.complex64:
        xs = [x + 1j * rng.randn(16) for x in xs]
    jx = [jnp.asarray(x, jnp.float64 if dtype == torch.float64
                      else jnp.complex64) for x in xs]
    want = np.asarray(jadasum._tree_fold(jx, use_pallas=False))
    got = tadasum._tree_fold([torch.from_numpy(np.array(x)) for x in jx])
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Routing: the port's answers against the reference's for every knob value.

PALLAS_VALUES = ["1", "true", "yes", "TRUE", "0", "false", "no", "auto"]
MODES = ["auto", "vhdd", "gather"]


@pytest.fixture
def modes():
    yield
    jadasum.set_adasum_mode("auto")
    tadasum.set_adasum_mode("auto")


class _Pair(ProcessSet):
    """A two-rank set whose gather hands back two given rows, so the
    route can be read without a process group."""

    def rank(self):
        return 0


def _route(monkeypatch, t):
    """'vhdd' when adasum_allreduce enters the vhdd route (``vhdd``),
    else the branch the gather fold took ('kernel' or 'plain')."""
    seen = []

    def combine(a, b, use_pallas=False, out=None):
        seen.append("kernel" if use_pallas else "plain")
        return a + b

    def vhdd(seg, me, n, wire, use_kernel=False):
        seen.append("vhdd")
        return seg

    monkeypatch.setattr(tadasum, "gather_rows", lambda flat, pset: [flat,
                                                                   flat])
    monkeypatch.setattr(tadasum, "_pair_combine", combine)
    monkeypatch.setattr(tadasum, "vhdd", vhdd)
    monkeypatch.setattr(tadasum, "_DistWire", lambda pset: None)
    tadasum.adasum_allreduce([t], _Pair([0, 1]))
    return seen[0]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pallas", PALLAS_VALUES)
def test_routing_matches_the_reference(pallas, mode, monkeypatch, modes):
    monkeypatch.setenv("HOROVOD_ADASUM_PALLAS", pallas)
    jadasum.set_adasum_mode(mode)
    tadasum.set_adasum_mode(mode)
    assert tadasum._pallas_forced() == jadasum._pallas_forced()
    # On the CPU backend "auto" is the plain path in both; the port's
    # "auto" for CUDA tensors is the reference's "auto" on the TPU.
    assert tadasum._use_pallas(cuda=False) == jadasum._use_pallas()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert tadasum._use_pallas(cuda=True) == jadasum._use_pallas()
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    # The route at world size 2: the reference's vhdd_ok rule, and the
    # gather fold's branch for float32 (kernel dtype) and float64.
    ref_vhdd = mode == "vhdd" or (mode == "auto"
                                  and not jadasum._pallas_forced())
    for dtype in (torch.float32, torch.float64):
        got = _route(monkeypatch, torch.ones(4, dtype=dtype))
        if ref_vhdd:
            assert got == "vhdd"
        else:
            want_kernel = jadasum._use_pallas() and \
                jadasum._pallas_ok_dtype(jnp.float64 if dtype == torch.float64
                                         else jnp.float32)
            assert got == ("kernel" if want_kernel else "plain")
    # Complex contributions always take the gather route.
    assert _route(monkeypatch, torch.ones(4, dtype=torch.complex64)) \
        == "plain"


def test_pallas_ok_dtype_matches_the_reference():
    pairs = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float16, jnp.float16), (torch.float64, jnp.float64),
             (torch.complex64, jnp.complex64)]
    for t, j in pairs:
        assert tadasum._pallas_ok_dtype(t) == jadasum._pallas_ok_dtype(j)


def test_bad_mode_raises(modes):
    with pytest.raises(ValueError, match="auto/vhdd/gather"):
        tadasum.set_adasum_mode("ring")
