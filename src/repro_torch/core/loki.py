"""Loki: PCA-based top-k sparse decode attention (paper Algorithm 1).

The torch counterpart of ``repro.core.loki``. The decode KV cache stores
keys in the PCA basis (K̂ = K_rope @ P, full D; Lemma 4.1 makes attention in
that basis exact). Each step:

  1. q̂ = q_rope @ P                                        (O(D²))
  2. approx scores from the first d = d_f·D components      (O(dS))
  3. top-k (k = k_f·S) token indices from approx scores     (O(S log S))
  4. exact attention over the selected keys/values only     (O(2Dk))

Two selection granularities: token (``loki_decode``, paper-faithful) and
block (``loki_decode_block``, the kernels' formulation).

``lax.top_k`` breaks ties toward the lower index; ``torch.topk`` promises
no order, so every top-k here is a stable descending sort (equal values
keep their index order) cut to k.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LokiConfig
from repro_torch.core.attention import (NEG_INF, attend_selected,
                                        decode_scores, gather_heads,
                                        length_mask, window_mask)
from repro_torch.serving.paged_cache import gather_logical_dq


def topk_lower_index(x, k: int):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index — ``lax.top_k``'s order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def project_qk(q, k, proj):
    """Rotate post-RoPE q/k into the PCA basis.

    q (B,H,D), k (B,Hkv,D) or (B,S,Hkv,D); proj (Hkv,D,D).
    Query heads use their kv-group's projection."""
    n_kv = proj.shape[0]
    b, h = q.shape[0], q.shape[1]
    qg = q.reshape(b, n_kv, h // n_kv, q.shape[-1])
    q_hat = torch.einsum("bhgd,hde->bhge", qg, proj.to(q.dtype))
    q_hat = q_hat.reshape(b, h, q.shape[-1])
    if k.ndim == 3:                                  # (B,Hkv,D) single token
        k_hat = torch.einsum("bhd,hde->bhe", k, proj.to(k.dtype))
    else:                                            # (B,S,Hkv,D)
        k_hat = torch.einsum("bshd,hde->bshe", k, proj.to(k.dtype))
    return q_hat, k_hat


def static_k(cfg: LokiConfig, smax: int) -> int:
    k = max(int(cfg.k_f * smax), cfg.min_k)
    return min(k, smax)


def select_topk(approx_scores, cfg: LokiConfig, cur_len, smax: int):
    """Token-granular selection. approx_scores (B,Hkv,G,S) fp32 (masked).

    Returns (idx (B,Hkv,G,K), valid (B,Hkv,G,K)). K is static (k_f * Smax);
    entries beyond k_f*cur_len are marked invalid (the dynamic budget)."""
    k = static_k(cfg, smax)
    taken, idx = topk_lower_index(approx_scores, k)
    cur_len = torch.as_tensor(cur_len, device=approx_scores.device)
    live = torch.clamp((cfg.k_f * cur_len).to(torch.int32), min=cfg.min_k)
    ranks = torch.arange(k, device=approx_scores.device)
    if cur_len.ndim == 0:
        valid = (ranks < live).expand(idx.shape)
    else:
        valid = (ranks[None, :] < live[:, None])[:, None, None, :]
        valid = valid.expand(idx.shape)
    # positions past cur_len were masked to NEG_INF; drop them too
    return idx, valid & (taken > NEG_INF / 2)


def _rotate_query(q_rope, proj, kd):
    b, h, dim = q_rope.shape
    n_kv = proj.shape[0]
    qg = q_rope.reshape(b, n_kv, h // n_kv, dim)
    q_hat = torch.einsum("bhgd,hde->bhge", qg, proj.to(q_rope.dtype))
    return q_hat.reshape(b, h, dim)[..., :kd]


def _masked_approx(q_hat, k_hat_cache, cur_len, cfg: LokiConfig, d: int,
                   scale: float, sliding_window: int):
    """Approximate scores from the leading d dims, with the length and
    sliding-window masks and the local window's +1e4 recency boost."""
    smax = k_hat_cache.shape[1]
    dev = q_hat.device
    approx = decode_scores(q_hat, k_hat_cache, d_slice=d, logit_scale=scale)
    m = length_mask(smax, cur_len, dev)
    if sliding_window:
        m = m & window_mask(smax, cur_len, sliding_window, dev)
    if cfg.local_window:
        recent = window_mask(smax, cur_len, cfg.local_window, dev)
        approx = torch.where(recent, approx + 1e4, approx)
    return torch.where(m, approx, NEG_INF)


def loki_decode(q_rope, k_hat_cache, v_cache, cur_len, proj,
                cfg: LokiConfig, *, sliding_window: int = 0,
                logit_scale=None):
    """Decode attention with Loki (Algorithm 1, lines 3-9), token top-k.

    q_rope       (B,H,D)    post-RoPE query (original basis)
    k_hat_cache  (B,Smax,Hkv,W) keys already in PCA basis, W <= D
    v_cache      (B,Smax,Hkv,D)
    proj         (Hkv,D,D)  PCA projection for this layer
    Returns (B,H,D)."""
    dim = q_rope.shape[-1]
    smax = k_hat_cache.shape[1]
    kd = k_hat_cache.shape[-1]
    d = min(max(int(cfg.d_f * dim), 8), kd)
    # sqrt(D) scaling regardless of the stored key width (Algorithm 2)
    scale = logit_scale if logit_scale is not None else dim ** -0.5
    q_hat = _rotate_query(q_rope, proj, kd)
    approx = _masked_approx(q_hat, k_hat_cache, cur_len, cfg, d, scale,
                            sliding_window)
    idx, valid = select_topk(approx, cfg, cur_len, smax)
    k_sel = gather_heads(k_hat_cache, idx)
    v_sel = gather_heads(v_cache, idx)
    return attend_selected(q_hat, k_sel, v_sel, valid, logit_scale=scale)


def loki_decode_block(q_rope, k_hat_cache, v_cache, cur_len, proj,
                      cfg: LokiConfig, *, sliding_window: int = 0,
                      logit_scale=None, group_select: bool = False,
                      page_table=None, page_size: int = 0,
                      k_scale=None, v_scale=None):
    """Block-granular Loki (the kernels' formulation; plain reference).

    Selection runs over per-block maxima of the approximate scores, and
    exact attention over the union of selected blocks. ``group_select``
    shares one selection across the GQA group (top-k of the per-block
    maxima reduced over the group's query heads) — the fused kernel's
    semantics; identical to per-head selection when G == 1.

    With ``page_table``/``page_size`` the caches are the paged engine's
    pools and the logical view is gathered first (dequantized through
    ``k_scale``/``v_scale`` for a quantized layout)."""
    if page_table is not None:
        k_hat_cache = gather_logical_dq(k_hat_cache, k_scale, page_table,
                                        page_size)
        v_cache = gather_logical_dq(v_cache, v_scale, page_table,
                                    page_size)
    dim = q_rope.shape[-1]
    smax = k_hat_cache.shape[1]
    kd = k_hat_cache.shape[-1]
    bs = cfg.block_size
    if smax % bs:
        raise ValueError("cache length must be a multiple of block_size")
    d = min(max(int(cfg.d_f * dim), 8), kd)
    n_blocks = smax // bs
    scale = logit_scale if logit_scale is not None else dim ** -0.5
    q_hat = _rotate_query(q_rope, proj, kd)
    approx = _masked_approx(q_hat, k_hat_cache, cur_len, cfg, d, scale,
                            sliding_window)
    blk = approx.reshape(*approx.shape[:-1], n_blocks, bs).amax(-1)

    k_blocks = max(int(cfg.k_f * n_blocks), 1)
    if group_select:
        blk_g = blk.amax(dim=2, keepdim=True)           # (B,Hkv,1,nb)
        taken, bidx = topk_lower_index(blk_g, k_blocks)  # (B,Hkv,1,kb)
        bidx = bidx.expand(*blk.shape[:-1], k_blocks)
        bvalid = (taken > NEG_INF / 2).expand(bidx.shape)
    else:
        taken, bidx = topk_lower_index(blk, k_blocks)   # (B,Hkv,G,kb)
        bvalid = taken > NEG_INF / 2

    # expand block indices -> token indices (kb*bs,)
    tok = bidx[..., None] * bs + torch.arange(bs, device=bidx.device)
    idx = tok.reshape(*tok.shape[:-2], k_blocks * bs)
    valid = bvalid[..., None].expand(tok.shape).reshape(idx.shape)
    valid = valid & (torch.gather(approx, -1, idx) > NEG_INF / 2)

    k_sel = gather_heads(k_hat_cache, idx)
    v_sel = gather_heads(v_cache, idx)
    return attend_selected(q_hat, k_sel, v_sel, valid, logit_scale=scale)
