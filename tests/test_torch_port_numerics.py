"""The port's numerics guard (``horovod_tpu_torch/numerics.py``) against
the JAX package's ``horovod_tpu/numerics.py`` on the CPU: the finite
flags and the imprint, ``params_digest`` (the same 64-bit value for the
same tree), ``guard_non_finite`` over a skip and a clean step against
``guard_non_finite(optax.adamw)``, escalation, and
``check_replica_divergence`` on spawned gloo worlds (which import no
JAX; ``spawn_world`` of tests/test_torch_port_distributed.py).

Tolerance: the clean AdamW step after a skip, relative 1e-6 per
element (float32 AdamW in torch and optax; one step).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import numerics as tnum
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 ReplicaDivergenceError)
from horovod_tpu_torch.parallel import train as ttrain
from test_torch_port_distributed import spawn_world

LR = 1e-2


def _trees(dtype):
    """The same tree on both sides: torch tensors and numpy arrays
    (bfloat16 through ml_dtypes on the reference's side)."""
    rng = np.random.RandomState(7)
    raw = {"w": rng.randn(3, 4), "layers": {"b": rng.randn(5),
                                            "s": np.asarray(rng.randn())},
           "list": [rng.randn(2, 2), rng.randn(1)]}

    def conv(x, torch_side):
        if isinstance(x, dict):
            return {k: conv(v, torch_side) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v, torch_side) for v in x]
        x = np.asarray(x * 100, np.int32) if dtype == "int32" else \
            np.asarray(x, np.float32)
        if torch_side:
            return torch.from_numpy(x).to(getattr(torch, dtype))
        import jax.numpy as jnp
        return np.asarray(jnp.asarray(x, getattr(jnp, dtype)))

    return conv(raw, True), conv(raw, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_params_digest_is_the_references(dtype):
    from horovod_tpu import numerics as jnum
    ttree, jtree = _trees(dtype)
    assert tnum.params_digest(ttree) == jnum.params_digest(jtree)
    flipped = dict(ttree, w=ttree["w"].clone())
    flipped["w"].view(-1)[0] += 1
    assert tnum.params_digest(flipped) != tnum.params_digest(ttree)


def test_params_digest_of_a_module_is_its_named_parameters():
    lin = torch.nn.Linear(3, 2)
    assert tnum.params_digest(lin) == tnum.params_digest(
        {"weight": lin.weight, "bias": lin.bias})


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf")])
def test_flags_and_imprint(bad):
    import jax.numpy as jnp
    from horovod_tpu import numerics as jnum
    rng = np.random.RandomState(1)
    arrs = [rng.randn(4).astype(np.float32), rng.randn(2, 3).astype(
        np.float32), np.arange(3, dtype=np.int32)]
    if bad is not None:
        arrs[1][1, 2] = bad
    ttree = {"a": torch.from_numpy(arrs[0]),
             "b": [torch.from_numpy(arrs[1]).to(torch.bfloat16),
                   torch.from_numpy(arrs[2])]}
    jtree = {"a": jnp.asarray(arrs[0]),
             "b": [jnp.asarray(arrs[1], jnp.bfloat16), jnp.asarray(arrs[2])]}
    ok = bool(tnum.all_finite(ttree))
    assert ok == bool(jnum.all_finite(jtree)) == (bad is None)
    flag = tnum.local_finite_flag([ttree["a"], *ttree["b"]])
    assert flag.dtype == torch.float32 and float(flag) == float(
        jnum.local_finite_flag([jtree["a"], *jtree["b"]]))
    assert tnum.imprint_non_finite(ttree, True) is ttree
    poisoned = tnum.imprint_non_finite(ttree, torch.tensor(False))
    jpoisoned = jnum.imprint_non_finite(jtree, False)
    assert torch.isnan(poisoned["a"]).all() and torch.isnan(
        poisoned["b"][0]).all()
    assert poisoned["b"][0].dtype == torch.bfloat16
    assert torch.equal(poisoned["b"][1], ttree["b"][1])
    np.testing.assert_array_equal(np.asarray(jpoisoned["b"][1]), arrs[2])


class _Two(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def test_guard_skips_and_applies_like_the_reference():
    import jax.numpy as jnp
    import optax
    from horovod_tpu import numerics as jnum
    rng = np.random.RandomState(3)
    w, b = rng.randn(3, 4).astype(np.float32), rng.randn(4).astype(np.float32)
    grads = [{"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)} for _ in range(3)]
    grads[1]["w"][2, 1] = np.nan                  # step 1 is vetoed
    model = _Two(w, b)
    opt = tnum.guard_non_finite(ttrain.adamw(model.parameters(), LR),
                                enabled=True)
    assert isinstance(opt, torch.optim.AdamW)
    tx = jnum.guard_non_finite(optax.adamw(LR), enabled=True)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    state = tx.init(params)
    history = []
    for g in grads:
        model.w.grad = torch.from_numpy(g["w"])
        model.b.grad = torch.from_numpy(g["b"])
        before = tnum.params_digest([dict(model.named_parameters()),
                                     [opt.state[p] for p in
                                      model.parameters()]])
        opt.step()
        after = tnum.params_digest([dict(model.named_parameters()),
                                    [opt.state[p] for p in
                                     model.parameters()]])
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        history.append((before == after, opt.consecutive_skips,
                        jnum.consecutive_skips(state)))
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7)
    assert history == [(False, 0, 0), (True, 1, 1), (False, 0, 0)]
    assert opt.total_skips == 1 == int(state.total_skips)
    assert opt.state[model.w]["step"] == 2      # the skip did not count


def test_guard_off_returns_the_optimizer_and_escalation_raises():
    opt = ttrain.adamw([torch.nn.Parameter(torch.zeros(2))], LR)
    assert tnum.guard_non_finite(opt, enabled=False) is opt
    p = torch.nn.Parameter(torch.zeros(2))
    opt = tnum.guard_non_finite(ttrain.adamw([p], LR), enabled=True,
                                max_consecutive=2)
    with pytest.raises(ValueError, match="already"):
        tnum.guard_non_finite(opt, enabled=True)
    p.grad = torch.tensor([float("nan"), 0.0])
    opt.step()
    assert tnum.consecutive_skips(opt) == 1
    tnum.check_escalation(opt, max_consecutive=2)       # below the limit
    with pytest.raises(HorovodInternalError, match="2 consecutive"):
        opt.step()
    with pytest.raises(HorovodInternalError):
        tnum.check_escalation([opt], max_consecutive=2)
    assert tnum.consecutive_skips([]) == 0


# ---------------------------------------------------------------------------
# check_replica_divergence on gloo worlds

def _flip(t):
    with torch.no_grad():
        raw = t.view(-1).view(torch.uint8)
        raw[raw.numel() // 2] ^= 0x10


def job_divergence(rank, size, args):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
    out = {}
    tnum.check_replica_divergence(model)          # agreement: no raise
    for name, culprit in args["cases"]:
        saved = model[0].weight.detach().clone()
        if rank == culprit:
            _flip(model[0].weight)
        try:
            tnum.check_replica_divergence(model)
            out[name] = ("none", None, "")
        except ReplicaDivergenceError as e:
            out[name] = ("ReplicaDivergenceError", list(e.divergent_ranks),
                         str(e))
        except RuntimeError as e:
            out[name] = ("RuntimeError", None, str(e))
        with torch.no_grad():
            model[0].weight.copy_(saved)
    return out


def test_divergence_named_in_a_world_of_three(tmp_path):
    outs = spawn_world(3, job_divergence, tmp_path, timeout=90,
                       cases=[("rank2", 2), ("rank0", 0)])
    for o in outs:
        kind, ranks, text = o["rank2"]
        assert (kind, ranks) == ("ReplicaDivergenceError", [2])
        assert "AMBIGUOUS" not in text
        kind, _, text = o["rank0"]
        assert kind == "RuntimeError" and "rank 0" in text
        assert "divergent ranks [0]" in text
        assert o["loaded"] == []


def test_divergence_in_a_world_of_two_is_ambiguous(tmp_path):
    outs = spawn_world(2, job_divergence, tmp_path, timeout=90,
                       cases=[("rank1", 1)])
    for o in outs:
        kind, ranks, text = o["rank1"]
        assert (kind, ranks) == ("ReplicaDivergenceError", [1])
        assert "AMBIGUOUS" in text
