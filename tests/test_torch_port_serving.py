"""The serving slice as a whole: horovod_tpu_torch's ServingFrontend
against the JAX package's, serving the same composed flagship forward
(transformer forward, LM head, last position's logits) on the same
weights carried across with ``params_from_jax``.

Small float32 config (see test_torch_port_transformer.py). Tolerance:
max abs error over max |reference| <= 1e-4 (summation order only).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serving as jserving
from horovod_tpu import weights as jweights
from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch.models import transformer as ttfm

L, VOCAB = 128, 256
SMALL = dict(vocab=VOCAB, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, max_seq=L)
ENV = {"HOROVOD_SERVING_MAX_BATCH": "4",
       "HOROVOD_SERVING_LATENCY_BUDGET_MS": "500",
       "HOROVOD_SERVING_MIN_WORKERS": "1",
       "HOROVOD_SERVING_MAX_WORKERS": "1"}
N_REQUESTS = 6


@pytest.fixture(autouse=True)
def _einsum_attention(monkeypatch):
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)


def _wait_warm(fe, n, timeout=120.0):
    deadline = time.monotonic() + timeout
    while fe.stats()["compiles"] < n:
        assert time.monotonic() < deadline, fe.stats()
        time.sleep(0.01)


def _serve(fe, requests):
    futs = [fe.submit(r) for r in requests]
    return [f.result(timeout=120) for f in futs]


def _buckets(fe):
    sizes = {}
    for rec in fe.traces():
        sizes[rec["batch"]] = sizes.get(rec["batch"], 0) + 1
    return sorted(fe.ladder.batch_bucket(n) for n in sizes.values())


def test_port_serves_what_the_jax_frontend_serves():
    jcfg = jtfm.TransformerConfig(**SMALL, dtype=jnp.float32,
                                  tp_axis=None, sp_axis=None,
                                  ep_axis=None)
    tcfg = ttfm.TransformerConfig(**SMALL, dtype=torch.float32)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    named = {n: np.asarray(a) for n, a in jweights.named_leaves(jparams)}
    model = ttfm.params_from_jax(tcfg, named, device="cpu")

    def jforward(params, tokens):
        hidden, _ = jtfm.forward(jcfg, params, tokens)
        return jtfm.logits_fn(jcfg, params, hidden[:, -1:])[:, -1]

    def tforward(params, tokens):
        hidden, _ = ttfm.forward(tcfg, params, tokens)
        return ttfm.logits_fn(tcfg, params, hidden[:, -1:])[:, -1]

    rng = np.random.RandomState(7)
    requests = [rng.randint(0, VOCAB, L).astype(np.int32)
                for _ in range(N_REQUESTS)]
    results, stats, buckets = {}, {}, {}
    for name, fe in (
            ("jax", jserving.ServingFrontend(
                jforward, (L,), "int32", env=ENV, autoscale=False,
                params=jparams)),
            ("port", tserving.ServingFrontend(
                tforward, (L,), "int32", env=ENV, autoscale=False,
                params=model, device="cpu"))):
        try:
            shapes = len(fe.ladder.shapes((L,)))
            _wait_warm(fe, shapes)
            assert fe.stats()["compiles"] == 1 * shapes == 3
            results[name] = _serve(fe, requests)
            stats[name] = fe.stats()
            buckets[name] = _buckets(fe)
        finally:
            fe.close()

    for name in ("jax", "port"):
        s = stats[name]
        assert s["compiles"] == 3, (name, s)        # no growth
        assert s["submitted"] == s["completed"] == N_REQUESTS, (name, s)
        assert s["failed"] == 0 and s["dropped"] == 0, (name, s)
        assert len(set(buckets[name])) > 1, (name, buckets[name])
    assert stats["port"]["worker_failures"] == []
    assert stats["port"]["ladder"] == stats["jax"]["ladder"]
    assert stats["port"]["ladder"]["digest"] == \
        "serving-ladder-v1|b=1,2,4|l=-"
    for got, ref in zip(results["port"], results["jax"]):
        assert got.dtype == np.float32 and got.shape == (VOCAB,)
        err = float(np.max(np.abs(got - np.asarray(ref))))
        assert err <= 1e-4 * float(np.max(np.abs(ref))), err


@pytest.mark.parametrize("max_batch,max_len", [
    (1, 0), (4, 0), (6, 0), (8, 64), (3, 16), (16, 200)])
def test_ladder_digest_matches_jax(max_batch, max_len):
    port = tserving.build_ladder(max_batch, max_len)
    ref = jserving.build_ladder(max_batch, max_len)
    assert port == ref
    assert port.shapes((5,)) == ref.shapes((5,))


def test_frontend_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tserving.ServingFrontend(lambda x: x, (4,), env=ENV,
                                 autoscale=False)


def test_worker_failure_is_counted_with_its_cause():
    def broken(x):
        raise ValueError("forward refused the batch")

    fe = tserving.ServingFrontend(broken, (4,), env=ENV,
                                  autoscale=False, device="cpu")
    try:
        deadline = time.monotonic() + 30
        while not fe.stats()["worker_failures"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        (wid, cause, error), = fe.stats()["worker_failures"]
        assert (wid, cause) == ("w0", "warmup")
        assert "forward refused the batch" in error
        assert fe.stats()["workers"] == 0
    finally:
        fe.close(timeout=1)


# bfloat16 on the wire (the port's declared form: a CPU torch.Tensor of
# dtype torch.bfloat16, see serving.py's docstring). Both frontends side by
# side on the two inputs: a forward that returns bfloat16 for float32
# requests, and bfloat16 requests. The values must be bitwise the
# reference's.
BF16_CASES = {
    "bf16_rows": (lambda x: (2 * x).astype(jnp.bfloat16),
                  lambda x: (2 * x).to(torch.bfloat16), "float32",
                  np.array([1.0, -0.3, 2.5e-3, 7.0], np.float32)),
    "bf16_requests": (lambda x: x * 3, lambda x: x * 3, "bfloat16",
                      np.array([1.5, -2.25, 0.1, 3.3e4], np.float32)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bfloat16_rows_and_requests_are_the_references(case):
    jfwd, tfwd, dtype, x = BF16_CASES[case]
    env = dict(ENV, HOROVOD_SERVING_LATENCY_BUDGET_MS="5")
    rows = {}
    for name, fe in (
            ("jax", jserving.ServingFrontend(jfwd, (4,), dtype, env=env,
                                             autoscale=False)),
            ("port", tserving.ServingFrontend(tfwd, (4,), dtype, env=env,
                                              autoscale=False,
                                              device="cpu"))):
        try:
            rows[name] = [f.result(timeout=60) for f in
                          [fe.submit(x), fe.submit(x[::-1].copy())]]
            assert fe.stats()["failed"] == 0
        finally:
            fe.close()
    for got, ref in zip(rows["port"], rows["jax"]):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
