"""Primitive layers: norms, MLP variants, embeddings, RoPE.

Counterpart of ``repro.models.layers``: plain functions over parameter
dicts of tensors. The JAX code casts each weight to the activation dtype at
every use (``w.astype(x.dtype)``); here the matrices are cast once when the
parameters are built (``models.lm.cast_params``), which gives the same
values, so the functions below use them as they come.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dot(x, w):
    return torch.matmul(x, w)


# ---------------------------------------------------------------- init
# Per-layer leaves are stacked on a leading L axis (``n_layers``), the JAX
# tree's layout; ``n_layers=None`` makes an unstacked leaf.

def _init(gen, shape, *, dtype, device, scale=None, n_layers=None):
    """normal(0, scale), scale 1/sqrt(fan_in) unless given, drawn in
    float32 from ``gen`` one layer at a time and cast to ``dtype`` (a
    float32 draw of a whole stack would double a full-width model's peak
    memory)."""
    scale = scale if scale is not None else shape[0] ** -0.5

    def one():
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    if n_layers is None:
        return one()
    out = torch.empty((n_layers,) + tuple(shape), dtype=dtype, device=device)
    for i in range(n_layers):
        out[i] = one()
    return out


# ---------------------------------------------------------------- norms

def init_norm(cfg: ModelConfig, *, device, n_layers=None):
    lead = () if n_layers is None else (n_layers,)
    f32 = dict(dtype=torch.float32, device=device)
    p = {"scale": torch.ones(lead + (cfg.d_model,), **f32)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), **f32)
    return p


def norm_apply(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    if "bias" in p:  # LayerNorm
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:            # RMSNorm
        ms = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(dt)


# ---------------------------------------------------------------- MLPs

def init_mlp(gen, cfg: ModelConfig, *, dtype, device, n_layers, d_ff=None):
    """Gated (swiglu/geglu) or plain (sq_relu/gelu) MLP params, hidden
    width ``d_ff`` (default ``cfg.d_ff``; xlstm's blocks use 2 d_model)."""
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    gated = cfg.mlp in ("swiglu", "geglu")
    kw = dict(dtype=dtype, device=device, n_layers=n_layers)
    return {"w_in": _init(gen, (d, 2 * f if gated else f), **kw),
            "w_out": _init(gen, (f, d), **kw)}


def mlp_apply(p, x, cfg: ModelConfig):
    f = p["w_out"].shape[0]
    h = dot(x, p["w_in"])
    if cfg.mlp in ("swiglu", "geglu"):
        gate, up = h[..., :f], h[..., f:]
        # jax.nn.gelu defaults to the tanh approximation
        act = (F.silu(gate) if cfg.mlp == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        h = act * up
    elif cfg.mlp == "sq_relu":
        h = torch.relu(h).square()
    else:
        h = F.gelu(h, approximate="tanh")
    return dot(h, p["w_out"])


# ---------------------------------------------------------------- embeddings

def init_embed(gen, cfg: ModelConfig, *, dtype, device):
    # 1/sqrt(d) keeps tied-unembed logits O(1) at init
    return {"table": _init(gen, (cfg.vocab, cfg.d_model), dtype=dtype,
                           device=device, scale=cfg.d_model ** -0.5)}


def embed_apply(p, tokens, cfg: ModelConfig):
    return p["table"][tokens.long()]


def unembed_apply(p, x, cfg: ModelConfig):
    """Logits in float32. A product of two bf16 values is exact in
    float32, so upcasting both sides equals a bf16 matmul with float32
    accumulation (the JAX code's ``preferred_element_type``)."""
    logits = torch.matmul(x.float(), p["table"].float().t())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    # made once per device: a host->device copy per call would make the
    # host wait for the card at every layer
    return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


def apply_rope(x, positions, theta=10000.0):
    """Half-split rotary embedding. x: (..., S, H, D); positions
    broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _freqs_on(d, float(theta), x.device)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    angles = angles[..., None, :]                           # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- losses

def softmax_xent(logits, labels, z_loss=0.0, mask=None):
    """logits (B,S,V) float32, labels (B,S) int. Returns the mean loss:
    ``logsumexp - logit[label]``, plus ``z_loss * lse**2`` when z_loss is
    set; with ``mask`` (B,S) the masked mean ``sum(loss * mask) /
    max(sum(mask), 1)``."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
