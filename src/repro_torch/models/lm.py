"""Language-model assembly, dense family (counterpart of ``repro.models.lm``).

One parameter tree, the JAX package's layout (per-layer leaves stacked on a
leading L axis), four entry points:

  init(cfg, ...)                                   -> params
  forward(params, tokens, cfg)                     -> (logits, aux)
  prefill(params, cfg, tokens, smax)               -> (logits, cache, pos_len)
  decode_step(params, cfg, cache, token, pos_len)  -> (logits, cache)

Caches are updated in place where the JAX code donated them. Block
composition: [attn, mlp]. Other families raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


def check_family(cfg: ModelConfig) -> None:
    """The port serves the dense family; the others come later."""
    if (cfg.family != "dense" or cfg.is_encoder_decoder or cfg.vision_tokens
            or cfg.window_layers is not None or not cfg.rope):
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family!r} is not ported yet (ROADMAP "
            "queue 1 item 8: other families); the port serves dense rotary "
            "models")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(params, i: int):
    """Layer i's parameters: views into the stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], params["layers"])


# --------------------------------------------------------------- init

#: leaves the JAX code casts to the activation dtype at every use; the
#: port casts them once (same values)
CAST_LEAVES = {"table", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_in",
               "w_out"}


def cast_params(params, cfg: ModelConfig):
    """Cast the matrices and biases to ``cfg.dtype`` once. Norm scales and
    biases and the ``pca`` projections stay float32, as the JAX code uses
    them."""
    dt = L.torch_dtype(cfg.dtype)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v.to(dt) if k in CAST_LEAVES else v)
                for k, v in tree.items()}
    return walk(params)


def init(cfg: ModelConfig, *, seed: int = 0,
         generator: Optional[torch.Generator] = None, device=None):
    """Random parameters: normal(0, 1/sqrt(fan_in)) matrices (embedding
    scale d_model**-0.5), unit norm scales, zero biases, identity PCA.
    The draws come from ``generator`` (or a fresh one seeded with
    ``seed``) on ``device``; they differ from ``jax.random``'s."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=L.torch_dtype(cfg.dtype), device=dev)
    n = cfg.n_layers
    return {
        "embed": L.init_embed(gen, cfg, **kw),
        "layers": {
            "ln1": L.init_norm(cfg, device=dev, n_layers=n),
            "attn": B.init_attention(gen, cfg, n_layers=n, **kw),
            "ln2": L.init_norm(cfg, device=dev, n_layers=n),
            "mlp": L.init_mlp(gen, cfg, n_layers=n, **kw),
        },
        "final_norm": L.init_norm(cfg, device=dev),
    }


# --------------------------------------------------------------- forward

def forward(params, tokens, cfg: ModelConfig, *, capture_keys: bool = False):
    """Teacher-forced forward -> (logits (B,S,V), aux). ``capture_keys``
    also returns (pre, post, q): pre/post-rotary keys (L,B,S,Hkv,D) and
    post-rotary queries (L,B,S,H,D) for PCA calibration."""
    check_family(cfg)
    x = L.embed_apply(params["embed"], tokens, cfg)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    captures = []
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        cap = {} if capture_keys else None
        h = L.norm_apply(p["ln1"], x)
        x = x + B.attn_train(p["attn"], h, positions, cfg, capture=cap)
        h = L.norm_apply(p["ln2"], x)
        x = x + L.mlp_apply(p["mlp"], h, cfg)
        if cap is not None:
            captures.append(cap)
    x = L.norm_apply(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if capture_keys:
        return logits, aux, tuple(torch.stack([c[n] for c in captures])
                                  for n in ("pre", "post", "q"))
    return logits, aux


# --------------------------------------------------------------- caches

def init_cache(cfg: ModelConfig, batch: int, smax: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Stacked (L, B, Smax, Hkv, D) decode cache for the whole model."""
    check_family(cfg)
    return {"layers": {"attn": B.init_attn_cache(
        cfg, batch, smax, dtype, resolve_device(device),
        n_layers=cfg.n_layers)}}


def layer_cache(cache, i: int):
    """Layer i's {"k","v"}: views, so writes land in the stacked cache."""
    return tree_map(lambda a: a[i], cache["layers"]["attn"])


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, smax: int, *,
            cache_dtype=torch.bfloat16, cache=None):
    """Process a prompt -> (logits_last (B,V), cache, pos_len (B,)).

    ``cache``: an existing (L, B, Smax, ...) cache (or a view of some of
    its slots) to fill in place instead of allocating a new one."""
    check_family(cfg)
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, smax, cache_dtype, device=tokens.device)
    x = L.embed_apply(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=tokens.device)[None]
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = L.norm_apply(p["ln1"], x)
        x = x + B.attn_prefill(p["attn"], layer_cache(cache, i), h,
                               positions, cfg)
        h = L.norm_apply(p["ln2"], x)
        x = x + L.mlp_apply(p["mlp"], h, cfg)
    x = L.norm_apply(params["final_norm"], x[:, -1:])
    logits = L.unembed_apply(params["embed"], x, cfg)[:, 0]
    pos_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache, pos_len


def _layer_decode(p, c, x, pos_len, cfg: ModelConfig):
    h = L.norm_apply(p["ln1"], x)
    x = x + B.attn_decode(p["attn"], c, h, pos_len, cfg)
    h = L.norm_apply(p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], h, cfg)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, token, pos_len):
    """One generation step. token (B,) int; pos_len (B,) tokens cached.
    Returns (logits (B,V) float32, cache) — the cache updated in place."""
    check_family(cfg)
    x = L.embed_apply(params["embed"], token, cfg)
    for i in range(cfg.n_layers):
        x = _layer_decode(layer_params(params, i), layer_cache(cache, i), x,
                          pos_len, cfg)
    x = L.norm_apply(params["final_norm"], x)
    return L.unembed_apply(params["embed"], x, cfg), cache
