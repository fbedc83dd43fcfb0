"""The exact top-k baseline the paper compares against (Section 5),
counterpart of ``repro.core.baselines``: full-dimensionality scores, then
top-k, then exact attention over the selection (the quality upper bound
for Loki). Two granularities: token (``exact_topk_decode``, the plain
reference) and block (``exact_topk_decode_block``, the fused kernel's
formulation and its oracle). The reference's ``pcaattn`` and ``h2o`` are
not ported yet (ROADMAP queue 1 item 4a).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LokiConfig
from repro_torch.core.attention import (NEG_INF, attend_selected,
                                        decode_scores, gather_heads,
                                        length_mask, window_mask)
from repro_torch.core.loki import select_topk, topk_lower_index
from repro_torch.serving.paged_cache import gather_logical_dq


def exact_topk_decode(q_rope, k_cache, v_cache, cur_len, cfg: LokiConfig,
                      *, logit_scale=None):
    """Top-k over exact scores, exact attention over the selection.
    q (B,H,W), caches (B,Smax,Hkv,·) -> (B,H,D)."""
    smax = k_cache.shape[1]
    scores = decode_scores(q_rope, k_cache, logit_scale=logit_scale)
    scores = torch.where(length_mask(smax, cur_len, q_rope.device), scores,
                         NEG_INF)
    idx, valid = select_topk(scores, cfg, cur_len, smax)
    k_sel = gather_heads(k_cache, idx)
    v_sel = gather_heads(v_cache, idx)
    return attend_selected(q_rope, k_sel, v_sel, valid,
                           logit_scale=logit_scale)


def exact_topk_decode_block(q, k_cache, v_cache, cur_len, cfg: LokiConfig,
                            *, logit_scale=None, sliding_window: int = 0,
                            group_select: bool = True, page_table=None,
                            page_size: int = 0, k_scale=None, v_scale=None):
    """Block-granular exact top-k: selection over per-block maxima of the
    exact full-width scores (no d-slice, no recency boost), exact
    attention over the union of the selected blocks. ``group_select``
    shares one selection across the GQA group, the fused kernel's
    semantics. With ``page_table``/``page_size`` the caches are pools and
    the logical view is gathered first."""
    if page_table is not None:
        k_cache = gather_logical_dq(k_cache, k_scale, page_table,
                                    page_size)
        v_cache = gather_logical_dq(v_cache, v_scale, page_table,
                                    page_size)
    smax = k_cache.shape[1]
    bs = cfg.block_size
    if smax % bs:
        raise ValueError("cache length must be a multiple of block_size")
    n_blocks = smax // bs
    dev = q.device

    scores = decode_scores(q, k_cache, logit_scale=logit_scale)
    m = length_mask(smax, cur_len, dev)
    if sliding_window:
        m = m & window_mask(smax, cur_len, sliding_window, dev)
    scores = torch.where(m, scores, NEG_INF)
    blk = scores.reshape(*scores.shape[:-1], n_blocks, bs).amax(-1)

    k_blocks = max(int(cfg.k_f * n_blocks), 1)
    if group_select:
        blk_g = blk.amax(dim=2, keepdim=True)            # (B,Hkv,1,nb)
        taken, bidx = topk_lower_index(blk_g, k_blocks)
        bidx = bidx.expand(*blk.shape[:-1], k_blocks)
        bvalid = (taken > NEG_INF / 2).expand(bidx.shape)
    else:
        taken, bidx = topk_lower_index(blk, k_blocks)    # (B,Hkv,G,kb)
        bvalid = taken > NEG_INF / 2

    tok = bidx[..., None] * bs + torch.arange(bs, device=dev)
    idx = tok.reshape(*tok.shape[:-2], k_blocks * bs)
    valid = bvalid[..., None].expand(tok.shape).reshape(idx.shape)
    valid = valid & (torch.gather(scores, -1, idx) > NEG_INF / 2)

    k_sel = gather_heads(k_cache, idx)
    v_sel = gather_heads(v_cache, idx)
    return attend_selected(q, k_sel, v_sel, valid, logit_scale=logit_scale)
