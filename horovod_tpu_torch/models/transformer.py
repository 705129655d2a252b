"""Flagship model: the Llama-style decoder transformer of
``horovod_tpu/models/transformer.py`` as PyTorch modules, on one
device.

Port scope: every strategy axis off (no tensor, sequence or expert
parallelism) and the dense SwiGLU FFN only; the MoE FFN and the
vocab-sharded (tp > 1) loss are not ported yet. The functions keep the
JAX module's names and math: ``rmsnorm`` and ``_rope`` compute in
float32 and cast back, norm weights stay float32 in a bfloat16 model,
the LM head is tied to the embedding and returns float32 logits,
attention goes through ``parallel.ring_attention.attention`` (and so,
on the card, through the flash kernels, forward and backward),
``loss_fn`` is the mean next-token cross-entropy plus 0.01 times the
aux loss, and ``cfg.remat`` recomputes each layer (``"full"``) or only
its FFN (``"mlp_only"``) in the backward with ``torch.utils.checkpoint``,
as ``jax.checkpoint`` does in the JAX ``forward``.

Weights: ``init_params`` draws them on the device from a seeded
``torch.Generator`` with the JAX init scales; ``params_from_jax``
carries a JAX parameter tree across and ``params_to_jax`` carries
parameters (or their gradients) back in the JAX layout. Linear weights
are stored the ``nn.Linear`` way, (out, in): the transpose of JAX's
(in, out).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.device import DeviceLike, resolve_device
from ..parallel.ring_attention import attention as full_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 1376
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Recompute each layer in the backward (the JAX config's remat):
    # "full" reruns the whole layer, attention's forward kernel
    # included; "mlp_only" keeps the attention sub-block's saved tensors
    # (so its forward kernel runs once) and reruns only the FFN.
    remat: bool = False
    remat_mode: str = "full"


# Linear weight name -> (out, in) shape, per layer.
def _layer_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    D, H, KV, Dh, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return {"wq": (H * Dh, D), "wk": (KV * Dh, D), "wv": (KV * Dh, D),
            "wo": (D, H * Dh), "w_gate": (F_, D), "w_up": (F_, D),
            "w_down": (D, F_)}


class Block(nn.Module):
    """One decoder layer: attention sub-block then dense FFN."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.mlp_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _attention_block(self.cfg, self, x)
        return _dense_ffn(self.cfg, self, x)


class Transformer(nn.Module):
    """Embedding (tied LM head), ``n_layers`` Blocks, final norm."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab, cfg.d_model, dtype=cfg.dtype, device=device))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self.cfg, self, tokens)


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Random weights drawn on ``device`` (the card unless
    ``device="cpu"``) from a ``torch.Generator`` seeded with ``seed``:
    normal times the JAX init scale (1.0 for the embedding, fan-in
    ** -0.5 for the rest), norms at one."""
    dev = resolve_device(device, "init_params")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, dev)

    def draw(p: torch.Tensor, scale: float) -> None:
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                dtype=torch.float32) * scale)

    draw(model.embed, 1.0)
    for layer in model.layers:
        for name in _layer_shapes(cfg):
            p = getattr(layer, name)
            draw(p, p.shape[1] ** -0.5)
    return model


def _jax_array(named: Dict[str, np.ndarray], key: str) -> torch.Tensor:
    arr = np.array(named[key])                  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(cfg: TransformerConfig, named: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Transformer:
    """The JAX package's parameter tree as this module's state.

    ``named`` maps the JAX package's leaf names (``weights.named_leaves``
    keys, e.g. ``"['layers']['wq']"``) to numpy arrays: layers stacked
    on a leading axis, linear weights (in, out). Each weight keeps its
    dtype; it must be the config's (float32 for norms)."""
    dev = resolve_device(device, "params_from_jax")
    model = Transformer(cfg, dev)

    def put(p: nn.Parameter, value: torch.Tensor, key: str) -> None:
        if value.shape != p.shape or value.dtype != p.dtype:
            raise ValueError(
                f"params_from_jax: {key} is {tuple(value.shape)} "
                f"{value.dtype}, the config wants {tuple(p.shape)} "
                f"{p.dtype}")
        with torch.no_grad():
            p.copy_(value)

    put(model.embed, _jax_array(named, "['embed']"), "['embed']")
    put(model.final_norm, _jax_array(named, "['final_norm']"),
        "['final_norm']")
    stacked = {}
    for name in ("attn_norm", "mlp_norm", *_layer_shapes(cfg)):
        key = f"['layers']['{name}']"
        stacked[name] = _jax_array(named, key)
        if stacked[name].shape[0] != cfg.n_layers:
            raise ValueError(f"params_from_jax: {key} stacks "
                             f"{stacked[name].shape[0]} layers, the "
                             f"config has {cfg.n_layers}")
    for i, layer in enumerate(model.layers):
        for name, arr in stacked.items():
            value = arr[i] if "norm" in name else arr[i].t()
            put(getattr(layer, name), value,
                f"['layers']['{name}'][{i}]")
    return model


def params_to_jax(cfg: TransformerConfig,
                  tensors: Union[nn.Module, Mapping[str, torch.Tensor]]
                  ) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: the JAX package's leaf names
    mapped to numpy arrays, layers stacked on a leading axis, linear
    weights (in, out). ``tensors`` is a Transformer (its parameters) or
    a mapping from its parameter names (``named_parameters()``, e.g.
    ``"layers.0.wq"``) to tensors, such as ``{name: p.grad}`` for the
    gradients in the JAX layout. bfloat16 comes back as float32, which
    holds it exactly (numpy has no bfloat16)."""
    if isinstance(tensors, nn.Module):
        tensors = dict(tensors.named_parameters())

    def host(name: str) -> np.ndarray:
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"params_to_jax: no tensor for {name} (a "
                             f"parameter without a gradient?)")
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    out = {"['embed']": host("embed"), "['final_norm']": host("final_norm")}
    for name in ("attn_norm", "mlp_norm", *_layer_shapes(cfg)):
        per_layer = [host(f"layers.{i}.{name}") for i in range(cfg.n_layers)]
        if "norm" not in name:
            per_layer = [a.T for a in per_layer]
        out[f"['layers']['{name}']"] = np.stack(per_layer)
    return out


# ---------------------------------------------------------------------------
# Building blocks (same names and math as the JAX module)

def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: (B, L, H, Dh); positions: (L,). Rotates halves."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].float() * freqs[None, :]        # (L, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def _attention_block(cfg: TransformerConfig, p: Block,
                     x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, D) -> x + attention(rmsnorm(x))."""
    B, L, D = x.shape
    Dh = cfg.head_dim
    h = rmsnorm(x, p.attn_norm)
    q = F.linear(h, p.wq).view(B, L, -1, Dh)
    kk = F.linear(h, p.wk).view(B, L, -1, Dh)
    v = F.linear(h, p.wv).view(B, L, -1, Dh)
    positions = torch.arange(L, device=x.device)
    q = _rope(q, positions, cfg.rope_theta)
    kk = _rope(kk, positions, cfg.rope_theta)
    # GQA: repeat kv heads to match q heads.
    reps = q.shape[2] // kk.shape[2]
    if reps > 1:
        kk = kk.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    o = full_attention(q, kk, v, causal=True)
    o = F.linear(o.reshape(B, L, -1), p.wo)
    return x + o.to(x.dtype)


def _dense_ffn(cfg: TransformerConfig, p: Block,
               x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p.mlp_norm)
    gate = F.silu(F.linear(h, p.w_gate).float())
    up = F.linear(h, p.w_up).float()
    out = F.linear((gate * up).to(x.dtype), p.w_down)
    return x + out.to(x.dtype)


def embed_lookup(cfg: TransformerConfig, embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, embed)


def _one_layer(cfg: TransformerConfig, layer: Block,
               x: torch.Tensor) -> torch.Tensor:
    """One layer, recomputed in the backward as ``cfg.remat`` says."""
    if not cfg.remat:
        return layer(x)
    if cfg.remat_mode == "mlp_only":
        x = _attention_block(cfg, layer, x)
        return checkpoint(_dense_ffn, cfg, layer, x, use_reentrant=False)
    return checkpoint(layer, x, use_reentrant=False)


def forward(cfg: TransformerConfig, params: Transformer,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, L) -> hidden states (B, L, D) and the MoE aux loss
    (always zero: the dense FFN has none)."""
    if cfg.remat and cfg.remat_mode not in ("full", "mlp_only"):
        raise ValueError(f"remat_mode must be 'full' or 'mlp_only', got "
                         f"{cfg.remat_mode!r}")
    x = embed_lookup(cfg, params.embed, tokens)
    for layer in params.layers:
        x = _one_layer(cfg, layer, x)
    x = rmsnorm(x, params.final_norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(cfg: TransformerConfig, params: Transformer,
              hidden: torch.Tensor) -> torch.Tensor:
    """LM head tied to the embedding: (B, L, vocab) float32. The
    model-dtype operands are exact in float32, so the float32 product
    is JAX's model-dtype matmul with a float32 accumulator."""
    h = hidden.to(cfg.dtype).float()
    e = params.embed.to(cfg.dtype).float()
    return torch.einsum("bld,vd->blv", h, e)


def vocab_parallel_xent(cfg: TransformerConfig, logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy, float32: the JAX function's ``tp == 1``
    branch (log-sum-exp minus the target's logit). Logits that hold
    only a shard of the vocabulary (tensor parallelism) raise
    NotImplementedError: that is a later slice of the port."""
    if logits.shape[-1] != cfg.vocab:
        raise NotImplementedError(
            f"vocab_parallel_xent: logits hold {logits.shape[-1]} of "
            f"{cfg.vocab} vocabulary entries; the vocab-sharded (tensor "
            f"parallel) loss is not ported yet (ROADMAP A.5)")
    lf = logits.float()
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - tgt


def loss_fn(cfg: TransformerConfig, params: Transformer,
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Next-token loss, mean over the batch: ``batch`` holds tokens and
    targets, both (B, L)."""
    hidden, aux = forward(cfg, params, batch["tokens"])
    logits = logits_fn(cfg, params, hidden)
    nll = vocab_parallel_xent(cfg, logits, batch["targets"])
    return nll.mean() + 0.01 * aux
