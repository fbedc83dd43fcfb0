"""Sparse-attention baselines the paper compares against (Section 5,
Table 1), counterpart of ``repro.core.baselines``.

* exact top-k: full-dimensionality scores, then top-k, then exact
  attention over the selection (the quality upper bound for Loki). Two
  granularities: token (``exact_topk_decode``, the plain reference) and
  block (``exact_topk_decode_block``, the fused kernel's formulation and
  its oracle).
* H2O: heavy-hitter token eviction with a fixed-budget cache (half heavy
  hitters by accumulated attention mass, half recent), permanent deletion.
* PCAAttn: the appendix E ablation, attention computed directly from the
  truncated d-dim PCA keys (known to fail; a negative control).

H2O and PCAAttn are plain torch, as they are jnp in the reference: no
TPU kernel computes them.
"""
from __future__ import annotations

from typing import NamedTuple

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


def pcaattn_decode(q_rope, k_hat_cache_d, v_cache, cur_len, proj,
                   cfg: LokiConfig, *, logit_scale=None):
    """Appendix E: softmax over truncated-basis scores directly.

    q_rope (B,H,D); k_hat_cache_d (B,Smax,Hkv,d) stores only the first d
    PCA dims (this variant shrinks the K half of the cache by d/D);
    v_cache (B,Smax,Hkv,D); proj (Hkv,D,D). Scores are scaled by D**-0.5
    (paper Algorithm 2 line 6), not d**-0.5. Returns (B,H,D)."""
    del cfg
    b, h, dim = q_rope.shape
    d = k_hat_cache_d.shape[-1]
    n_kv = proj.shape[0]
    qg = q_rope.reshape(b, n_kv, h // n_kv, dim)
    q_hat = torch.einsum("bhgd,hde->bhge", qg,
                         proj[..., :d].to(q_rope.dtype)).reshape(b, h, d)
    scale = logit_scale if logit_scale is not None else dim ** -0.5
    scores = decode_scores(q_hat, k_hat_cache_d, logit_scale=scale)
    scores = torch.where(length_mask(k_hat_cache_d.shape[1], cur_len,
                                     q_rope.device), scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache)
    return out.reshape(b, h, v_cache.shape[-1])


# ----------------------------------------------------------------- H2O

class H2OState(NamedTuple):
    """Fixed-budget eviction cache, slots [0, budget)."""
    k: torch.Tensor       # (B, budget, Hkv, D)
    v: torch.Tensor       # (B, budget, Hkv, D)
    pos: torch.Tensor     # (B, budget) int32 original positions, -1 empty
    acc: torch.Tensor     # (B, Hkv, budget) float32 accumulated mass
    fill: torch.Tensor    # (B,) int32 number of live slots


def h2o_init(batch: int, budget: int, n_kv: int, d: int,
             dtype=torch.bfloat16, device=None) -> H2OState:
    return H2OState(
        k=torch.zeros((batch, budget, n_kv, d), dtype=dtype, device=device),
        v=torch.zeros((batch, budget, n_kv, d), dtype=dtype, device=device),
        pos=torch.full((batch, budget), -1, dtype=torch.int32,
                       device=device),
        acc=torch.zeros((batch, n_kv, budget), dtype=torch.float32,
                        device=device),
        fill=torch.zeros((batch,), dtype=torch.int32, device=device))


def h2o_decode(q_rope, k_new, v_new, state: H2OState, step, *,
               recent_frac: float = 0.5, logit_scale=None,
               inplace: bool = False):
    """One H2O decode step, in the reference's order: insert the new token
    (into the next free slot, or over the evicted one once the budget is
    full), attend over the live slots, then add the step's attention mass
    (the mean over each group's query heads) to ``acc``. Eviction takes
    the slot of least mean mass over the kv heads among those that are
    neither recent (``pos >= step - budget * recent_frac``) nor empty,
    ties to the lowest slot (``jnp.argmin``'s order).

    q_rope (B,H,D); k_new/v_new (B,Hkv,D); step (B,) or an int, the new
    token's position. Returns (out (B,H,D), new state): new tensors, or
    with ``inplace`` the input state's own tensors updated in place (the
    engines' caches, which the JAX code donates)."""
    b, h, d = q_rope.shape
    budget, n_kv = state.k.shape[1], state.k.shape[2]
    dev = q_rope.device
    step = torch.as_tensor(step, dtype=torch.int32, device=dev).expand(b)
    rows = torch.arange(b, device=dev)

    # 1. insert the new token first, so it is attended this step
    full = state.fill >= budget
    recent_slots = int(budget * recent_frac)
    is_recent = state.pos >= (step[:, None] - recent_slots)
    score_for_evict = state.acc.mean(dim=1)                   # (B,budget)
    score_for_evict = torch.where(is_recent | (state.pos < 0),
                                  torch.inf, score_for_evict)
    # torch.argmin promises the first minimum, as jnp.argmin does
    evict_slot = torch.argmin(score_for_evict, dim=-1)        # (B,)
    slot = torch.where(full, evict_slot, state.fill.long())

    k_cache, v_cache, pos, acc, fill = (
        state if inplace else tuple(t.clone() for t in state))
    k_cache[rows, slot] = k_new.to(k_cache.dtype)
    v_cache[rows, slot] = v_new.to(v_cache.dtype)
    pos[rows, slot] = step
    # acc[b, :, slot[b]] = 0 as a scatter: the indexed assignment across
    # the head axis syncs the host on the card
    acc.scatter_(2, slot[:, None, None].expand(b, n_kv, 1), 0.0)
    fill.copy_(torch.clamp(fill + 1, max=budget))

    # 2. attend over the live slots
    scale = logit_scale if logit_scale is not None else d ** -0.5
    qg = q_rope.reshape(b, n_kv, h // n_kv, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float() * scale,
                          k_cache.float())
    live = pos >= 0                                           # (B,budget)
    scores = torch.where(live[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w.to(v_cache.dtype), v_cache)

    # 3. accumulate the attention mass (mean over query groups)
    acc += w.mean(dim=2)
    return (out.reshape(b, h, d),
            H2OState(k_cache, v_cache, pos, acc, fill))
