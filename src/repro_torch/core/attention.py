"""Attention: full (train/prefill, chunked softmax) + decode helpers.

The torch counterpart of ``repro.core.attention``. Decode-time attention is
expressed as pluggable policies (see loki.py); this module holds the shared
math: GQA-aware score computation, chunked causal attention and masking.

Shapes (conventions used throughout the package):
  q          (B, S, H,   Dh)
  k, v       (B, S, Hkv, Dh)
  kv cache   (B, Smax, Hkv, Dh)
  decode q   (B, H, Dh)        — a single new token per slot

Score products take their inputs in float32: a bf16 × bf16 product is exact
in float32, so this equals the JAX code's bf16 matmul with float32
accumulation (``preferred_element_type=jnp.float32``). Decode scores scale
the query in float32, as the CUDA kernels (and the TPU kernels) do; the JAX
code's plain path scales a bf16 query in bf16 first. The two agree exactly
in float32 and differ by that one rounding in bf16.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _group(q, n_kv):
    """(B,S,H,D) -> (B,S,Hkv,G,D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def causal_attention(q, k, v, *, causal=True, sliding_window=0,
                     chunk=512, logit_scale=None):
    """Chunked softmax attention: memory O(S * chunk), not O(S^2).

    q (B,S,H,D); k,v (B,S,Hkv,D). Returns (B,S,H,D) in v's dtype. Each
    query row's softmax is independent of the others, so the last chunk
    may be shorter than ``chunk``."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    n_kv = k.shape[2]
    scale = logit_scale if logit_scale is not None else d ** -0.5
    qg = _group(q, n_kv) * scale                       # (B,S,Hkv,G,D)
    kT = k.transpose(1, 2).float()                     # (B,Hkv,Sk,D)
    vT = v.transpose(1, 2)
    kv_pos = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, s, chunk):
        qc = qg[:, c0:c0 + chunk]
        q_pos = torch.arange(c0, c0 + qc.shape[1], device=q.device)
        scores = torch.einsum("bchgd,bhsd->bhgcs", qc.float(), kT)
        mask = torch.ones((qc.shape[1], sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if sliding_window:
            mask &= q_pos[:, None] - kv_pos[None, :] < sliding_window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhgcs,bhsd->bchgd", w, vT))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, s, h, d)


# ------------------------------------------------------------ decode scores

def decode_scores(q, k_cache, *, d_slice=None, logit_scale=None):
    """Scores of one new token against the cache.

    q (B,H,D), k_cache (B,Smax,Hkv,D) -> (B,Hkv,G,Smax) fp32 (unmasked).
    ``d_slice`` restricts the contraction to the first d feature dims
    (Loki's approximate scoring)."""
    b, h, d = q.shape
    n_kv = k_cache.shape[2]
    scale = logit_scale if logit_scale is not None else d ** -0.5
    qg = q.reshape(b, n_kv, h // n_kv, d)
    if d_slice is not None and d_slice < d:
        qg = qg[..., :d_slice]
        k_cache = k_cache[..., :d_slice]
    return torch.einsum("bhgd,bshd->bhgs", qg.float() * scale,
                        k_cache.float())


def _as_len(cur_len, device):
    return torch.as_tensor(cur_len, device=device)


def length_mask(smax: int, cur_len, device=None):
    """(1,1,1,Smax) or (B,1,1,Smax) mask of cache positions < cur_len."""
    cur_len = _as_len(cur_len, device)
    pos = torch.arange(smax, device=cur_len.device)
    if cur_len.ndim == 0:
        return (pos < cur_len)[None, None, None, :]
    return (pos[None, :] < cur_len[:, None])[:, None, None, :]


def window_mask(smax: int, cur_len, window: int, device=None):
    cur_len = _as_len(cur_len, device)
    pos = torch.arange(smax, device=cur_len.device)
    if cur_len.ndim == 0:
        return (pos >= cur_len - window)[None, None, None, :]
    return (pos[None, :] >= (cur_len[:, None] - window))[:, None, None, :]


def decode_full(q, k_cache, v_cache, cur_len, *, sliding_window=0,
                logit_scale=None):
    """Vanilla decode attention over the whole (valid) cache."""
    scores = decode_scores(q, k_cache, logit_scale=logit_scale)
    dev = q.device
    m = length_mask(k_cache.shape[1], cur_len, dev)
    if sliding_window:
        m = m & window_mask(k_cache.shape[1], cur_len, sliding_window, dev)
    scores = torch.where(m, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache)
    b, _, _, d = out.shape
    return out.reshape(b, q.shape[1], d)


def gather_heads(cache, idx):
    """Gather cache rows per (kv-head, group).

    cache (B,S,Hkv,D), idx (B,Hkv,G,K) -> (B,Hkv,G,K,D)."""
    b, s, n_kv, d = cache.shape
    g, k = idx.shape[2], idx.shape[3]
    c = cache.transpose(1, 2)                          # (B,Hkv,S,D)
    flat = idx.reshape(b, n_kv, g * k).long()
    out = torch.gather(c, 2, flat[..., None].expand(b, n_kv, g * k, d))
    return out.reshape(b, n_kv, g, k, d)


def attend_selected(q, k_sel, v_sel, valid, *, logit_scale=None):
    """Exact attention over a selected key subset.

    q (B,H,W); k_sel (B,Hkv,G,K,W); v_sel (B,Hkv,G,K,D); valid
    (B,Hkv,G,K) bool. The output width follows V, not the query."""
    b, h, d = q.shape
    n_kv = k_sel.shape[1]
    scale = logit_scale if logit_scale is not None else d ** -0.5
    qg = q.reshape(b, n_kv, h // n_kv, d).float() * scale
    scores = torch.einsum("bhgd,bhgkd->bhgk", qg, k_sel.float())
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_sel.dtype)
    out = torch.einsum("bhgk,bhgkd->bhgd", w, v_sel)
    return out.reshape(b, h, v_sel.shape[-1])
