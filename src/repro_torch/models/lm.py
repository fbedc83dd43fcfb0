"""Language-model assembly, dense family (counterpart of ``repro.models.lm``).

One parameter tree, the JAX package's layout (per-layer leaves stacked on a
leading L axis), and its entry points:

  init(cfg, ...)                                   -> params
  forward(params, tokens, cfg)                     -> (logits, aux)
  prefill(params, cfg, tokens, smax)               -> (logits, cache, pos_len)
  decode_step(params, cfg, cache, token, pos_len)  -> (logits, cache)
  init_paged_cache(cfg, n_pages, page_size)        -> paged cache
  prefill_chunk(params, cfg, cache, tokens, pos_start, n_valid,
                page_table, page_size)             -> (logits, cache)
  decode_step(..., page_table=, page_size=)        -> (logits, cache)

Caches are updated in place where the JAX code donated them. Block
composition: [attn, mlp]. Other families raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, PageLayout
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import paged_cache as PC


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


def _layer_decode(p, c, x, pos_len, cfg: ModelConfig, *, page_table=None,
                  page_size: int = 0):
    h = L.norm_apply(p["ln1"], x)
    x = x + B.attn_decode(p["attn"], c, h, pos_len, cfg,
                          page_table=page_table, page_size=page_size)
    h = L.norm_apply(p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], h, cfg)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, token, pos_len, *,
                page_table=None, page_size: int = 0, live=None,
                frame_table=None, slot_idx=None):
    """One generation step. token (B,) int; pos_len (B,) tokens cached.
    Returns (logits (B,V) float32, cache) — the cache updated in place.

    With ``page_table (B, max_pages)``/``page_size`` the cache is the
    pooled layout of ``init_paged_cache`` and every layer's reads and
    writes resolve through the table. The reference's ``live`` (StateSlot
    families), ``slot_idx`` (packed decode), ``frame_table`` (tiered pool)
    and rank-3 tables (page-table groups) are not ported yet (ROADMAP
    queue 1 items 7-8) and raise."""
    check_family(cfg)
    if live is not None or slot_idx is not None or frame_table is not None:
        raise NotImplementedError(
            "decode_step: live / slot_idx / frame_table are not ported yet "
            "(ROADMAP queue 1 items 7-8)")
    if page_table is not None and page_table.ndim != 2:
        raise NotImplementedError("page-table groups (rank-3 tables) are "
                                  "not ported yet (ROADMAP queue 1 item 7)")
    x = L.embed_apply(params["embed"], token, cfg)
    for i in range(cfg.n_layers):
        x = _layer_decode(layer_params(params, i), layer_cache(cache, i), x,
                          pos_len, cfg, page_table=page_table,
                          page_size=page_size)
    x = L.norm_apply(params["final_norm"], x)
    return L.unembed_apply(params["embed"], x, cfg), cache


# --------------------------------------------------------------- paged

def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, n_slots: int = 1,
                     device_pages: Optional[int] = None, device=None):
    """Paged decode cache: per layer a shared pool
    (n_pages * page_size, Hkv, W) of K and of V, stacked on a leading L
    axis, no batch dim; requests map logical positions to pool rows through
    per-slot page tables. Memory follows the page budget, not
    n_slots * smax. ``n_slots`` sizes per-slot state, which the dense
    family has none of.

    The layout (``cfg.page_layout``) sets the pools' storage dtype and the
    key width W (rank r under the pca basis); the default layout keeps the
    caller's ``dtype``, as the reference does. Quantized layouts (int8,
    fp8) add (L, n_pages) float32 ``k_scale``/``v_scale`` sidecars, zero
    until a page is written. The reference's tiered pool (``device_pages``)
    is not ported yet (ROADMAP queue 1 item 7); like the reference it
    refuses quantized layouts."""
    check_family(cfg)
    CS.assert_pageable(cfg)
    B.check_policy(cfg)
    spec = CS.layer_specs(cfg)[0].attn
    lay = spec.layout
    if device_pages is not None:
        if lay.quantized:
            raise ValueError("tiered pools require a non-quantized "
                             "PageLayout (per-page scale RMW is not "
                             "replay-idempotent)")
        raise NotImplementedError("tiered KV pools are not ported yet "
                                  "(ROADMAP queue 1 item 7)")
    pdt = dtype if lay == PageLayout() else PC.STORAGE_DTYPE[lay.dtype]
    dev = resolve_device(device)
    rows = n_pages * page_size
    lead = (cfg.n_layers, rows, spec.n_kv_heads)
    attn = {"k": torch.zeros(lead + (spec.k_width,), dtype=pdt, device=dev),
            "v": torch.zeros(lead + (spec.head_dim,), dtype=pdt,
                             device=dev)}
    if lay.quantized:
        for name in ("k_scale", "v_scale"):
            attn[name] = torch.zeros((cfg.n_layers, n_pages),
                                     dtype=torch.float32, device=dev)
    return {"layers": {"attn": attn}}


@torch.no_grad()
def prefill_chunk(params, cfg: ModelConfig, cache, tokens, pos_start: int,
                  n_valid: int, page_table, page_size: int, *, slot=None,
                  frame_row=None):
    """One step of a paged, chunked prefill for a single request.

    tokens (1, C): a fixed-size chunk whose first ``n_valid`` entries are
    real prompt tokens at logical positions ``pos_start ..
    pos_start+C-1`` (the rest is padding, written to the trash page).
    page_table (1, max_pages) or (max_pages,). Each layer scatters the
    chunk's K/V into the pools in place and attends causally over the
    cached prefix plus the chunk. Returns (logits (1, V) of chunk token
    ``n_valid - 1``, cache). ``slot`` addresses per-slot state, which the
    dense family has none of; the tiered pool's ``frame_row`` is not
    ported yet (ROADMAP queue 1 item 7)."""
    check_family(cfg)
    CS.assert_pageable(cfg)
    if frame_row is not None:
        raise NotImplementedError("tiered KV pools are not ported yet "
                                  "(ROADMAP queue 1 item 7)")
    if page_table.ndim > 2:
        raise NotImplementedError("page-table groups (rank-3 tables) are "
                                  "not ported yet (ROADMAP queue 1 item 7)")
    table_row = page_table[0] if page_table.ndim == 2 else page_table
    x = L.embed_apply(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = L.norm_apply(p["ln1"], x)
        x = x + B.attn_prefill_chunk(p["attn"], layer_cache(cache, i), h,
                                     pos_start, n_valid, cfg,
                                     table_row=table_row,
                                     page_size=page_size)
        h = L.norm_apply(p["ln2"], x)
        x = x + L.mlp_apply(p["mlp"], h, cfg)
    x = L.norm_apply(params["final_norm"], x[:, n_valid - 1:n_valid])
    logits = L.unembed_apply(params["embed"], x, cfg)[:, 0]
    return logits, cache
