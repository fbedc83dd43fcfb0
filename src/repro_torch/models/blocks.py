"""Attention block: params, train forward, prefill and one-token decode.

Counterpart of the attention half of ``repro.models.blocks`` for the dense
family, over the contiguous cache of the slot engine or the paged pool of
the paged engine. ``pos_len`` is the number of tokens already cached (B,):
the new token lands at that index and RoPE uses it as its position.

Policies: ``full`` and ``exact_topk`` (the CUDA kernels through
core/dispatch.py, or the plain references on backend="xla"), ``loki``
(token top-k, plain torch as in JAX) and ``loki_block`` (the CUDA kernels
through core/dispatch.py).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import dispatch, loki
from repro_torch.models import layers as L
from repro_torch.serving import paged_cache as PC

#: the attention policies the port serves
PORTED_POLICIES = ("full", "exact_topk", "loki", "loki_block")

#: policies of the JAX package the port does not carry yet, with the
#: ROADMAP item that will
UNPORTED_POLICIES = {
    "pcaattn": "ROADMAP queue 1: pcaattn policy",
    "h2o": "ROADMAP queue 1: h2o policy",
}


def check_policy(cfg: ModelConfig) -> None:
    policy = cfg.attn_policy()
    if policy in UNPORTED_POLICIES:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet "
            f"({UNPORTED_POLICIES[policy]})")
    if policy not in PORTED_POLICIES:
        raise ValueError(f"unknown attention policy {policy!r}; the port "
                         f"serves {PORTED_POLICIES}")
    if policy == "loki" and cfg.loki.n_chunks:
        raise NotImplementedError("loki_decode_chunked is not ported yet "
                                  "(ROADMAP queue 1)")


def init_attention(gen, cfg: ModelConfig, *, dtype, device, n_layers):
    """Projections, qkv biases (zero) and the per-KV-head PCA basis
    (identity until calibrated, float32), stacked over ``n_layers``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device, n_layers=n_layers)
    p = {"wq": L._init(gen, (d, cfg.q_dim), **kw),
         "wk": L._init(gen, (d, cfg.kv_dim), **kw),
         "wv": L._init(gen, (d, cfg.kv_dim), **kw),
         "wo": L._init(gen, (cfg.q_dim, d), **kw),
         "pca": torch.eye(hd, dtype=torch.float32, device=device).expand(
             n_layers, cfg.n_kv_heads, hd, hd).contiguous()}
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                            ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n_layers, width), dtype=dtype,
                                  device=device)
    return p


def _qkv(p, x, cfg: ModelConfig):
    """x (B,S,E) -> q (B,S,H,D), k/v (B,S,Hkv,D)."""
    hd = cfg.resolved_head_dim
    q = L.dot(x, p["wq"])
    k = L.dot(x, p["wk"])
    v = L.dot(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    b, s = x.shape[:2]
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def attn_train(p, x, positions, cfg: ModelConfig, *, capture=None):
    """Full causal attention. ``capture``: optional dict that receives the
    pre/post-rotary keys (and post-rotary queries) for PCA calibration."""
    q, k, v = _qkv(p, x, cfg)
    if capture is not None:
        capture["pre"] = k
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    if capture is not None:
        capture["post"] = k
        capture["q"] = q
    out = A.causal_attention(q, k, v, causal=True,
                             sliding_window=cfg.sliding_window)
    b, s = x.shape[:2]
    return L.dot(out.reshape(b, s, cfg.q_dim), p["wo"])


def init_attn_cache(cfg: ModelConfig, batch: int, smax: int, dtype,
                    device, n_layers: int = 1):
    """Zeroed (n_layers, B, Smax, Hkv, D) K and V caches."""
    check_policy(cfg)
    shape = (n_layers, batch, smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_cache(cache_arr, new, pos_len):
    """Write new (B,Hkv,D) rows at per-slot positions pos_len (B,), in
    place (the JAX code donates the cache buffer). Positions clamp to the
    last row, as ``dynamic_update_slice`` clamps its start index."""
    b = new.shape[0]
    rows = pos_len.long().clamp(0, cache_arr.shape[1] - 1)
    cache_arr[torch.arange(b, device=new.device), rows] = \
        new.to(cache_arr.dtype)


def _stores_pca(policy: str) -> bool:
    """Loki policies keep cache keys in the PCA basis (paper lines 3-4)."""
    return policy in ("loki", "loki_block")


def attn_decode(p, cache, x, pos_len, cfg: ModelConfig, *,
                sliding_window=None, page_table=None, page_size: int = 0):
    """One-token decode with the configured attention policy.

    x (B,E); pos_len (B,) tokens already cached; cache {"k","v"} of
    (B,Smax,Hkv,·), or with ``page_table (B, max_pages)``/``page_size``
    the paged pools (R,Hkv,·): the new token's K/V scatter through the
    table to their pool rows. Updated in place. Returns y (B,E)."""
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    q, k, v = _qkv(p, x[:, None, :], cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]          # (B,H,D)/(B,Hkv,D)
    positions = pos_len.expand(b)
    if cfg.rope:
        q = L.apply_rope(q[:, None], positions[:, None],
                         cfg.rope_theta)[:, 0]
        k = L.apply_rope(k[:, None], positions[:, None],
                         cfg.rope_theta)[:, 0]

    policy = cfg.attn_policy()
    proj = p["pca"]
    cur_len = positions + 1                       # cache incl. new token
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    paged = page_table is not None
    lay = cfg.page_layout
    if _stores_pca(policy):
        _, k_store = loki.project_qk(q, k, proj)
    elif paged and lay.basis == "pca":
        # latent-basis pages for full / exact_topk: store k̂ = k·P and
        # rotate q at read time (exact at full rank, Lemma 4.1)
        k_store = torch.einsum("bhd,hde->bhe", k, proj.to(k.dtype))
    else:
        k_store = k
    scales = {}
    if paged:
        # the pool's width is the stored key width: rank-r truncation
        k_store = k_store[..., :cache["k"].shape[-1]]
        for name, new in (("k", k_store), ("v", v)):
            if lay.quantized:
                PC.write_token_rows_q(cache[name], cache[name + "_scale"],
                                      new, page_table, positions, page_size,
                                      qmax=lay.qmax)
            else:
                PC.write_token_rows(cache[name], new, page_table, positions,
                                    page_size)
        if lay.quantized:
            scales = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    else:
        _write_cache(cache["k"], k_store, pos_len)
        _write_cache(cache["v"], v, pos_len)
    pargs = dict(page_table=page_table, page_size=page_size, **scales)

    # queries follow the storage basis; hd**-0.5 stays the logit scale
    # when the stored key width is the latent rank r < hd
    q_read = q
    if paged and lay.basis == "pca" and policy in ("full", "exact_topk"):
        qg = q.reshape(b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, hd)
        qh = torch.einsum("bhgd,hde->bhge", qg, proj.to(q.dtype))
        q_read = qh[..., :lay.k_width(hd)].reshape(b, cfg.n_heads, -1)

    if policy == "full":
        out = dispatch.full_paged_decode(q_read, cache["k"], cache["v"],
                                         cur_len, backend=cfg.loki.backend,
                                         block_size=cfg.loki.block_size,
                                         sliding_window=sw,
                                         logit_scale=hd ** -0.5, **pargs)
    elif policy == "exact_topk":
        out = dispatch.exact_topk_paged_decode(q_read, cache["k"],
                                               cache["v"], cur_len, cfg.loki,
                                               logit_scale=hd ** -0.5,
                                               **pargs)
    elif policy == "loki":
        kc, vc = dispatch.gathered(cache["k"], cache["v"], **pargs)
        out = loki.loki_decode(q, kc, vc, cur_len, proj, cfg.loki,
                               sliding_window=sw)
    elif policy == "loki_block":
        out = dispatch.loki_block_decode(q, cache["k"], cache["v"], cur_len,
                                         proj, cfg.loki, sliding_window=sw,
                                         **pargs)
    else:
        check_policy(cfg)
        raise AssertionError(policy)
    # the plain paths return the cache's dtype (float32 in both engines)
    # where the kernels return the query's: both continue in the
    # activation dtype (a no-op when the model computes in float32)
    return L.dot(out.reshape(b, cfg.q_dim).to(x.dtype), p["wo"])


def attn_prefill(p, cache, x, positions, cfg: ModelConfig):
    """Process a whole prompt, writing cache rows [0, S) in place. The
    cache stores keys in the policy's basis so decode steps are pure
    Algorithm 1. Returns y."""
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    out = A.causal_attention(q, k, v, causal=True,
                             sliding_window=cfg.sliding_window)
    b, s = x.shape[:2]
    y = L.dot(out.reshape(b, s, cfg.q_dim), p["wo"])
    if _stores_pca(cfg.attn_policy()):
        k_store = torch.einsum("bshd,hde->bshe", k, p["pca"].to(k.dtype))
    else:
        k_store = k
    cache["k"][:, :s] = k_store.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return y


def attn_prefill_chunk(p, cache, x, pos_start: int, n_valid: int,
                       cfg: ModelConfig, *, table_row, page_size: int):
    """One chunk of a paged, chunked prefill for a single request.

    x (1,C,E) holds the chunk's embeddings at logical positions
    ``pos_start .. pos_start+C-1``; only the first ``n_valid`` are real
    (the scheduler zero-pads the final chunk to a fixed size). The chunk's
    K/V scatter through ``table_row (max_pages,)`` into the pools in place
    (pad rows go to the trash page), then the chunk attends causally over
    [0, pos_start+C) through the logical view. Returns y (1,C,E).

    Exact across chunks: the cached prefix holds keys in the policy's
    storage basis, so prefix scores are taken in that basis (q̂·k̂ equals
    q·k for an orthogonal P, Lemma 4.1); the chunk's own columns use the
    fresh original-basis keys, as the one-shot prefill does."""
    b, c = x.shape[:2]
    q, k, v = _qkv(p, x, cfg)
    positions = pos_start + torch.arange(c, device=x.device)[None]  # (1,C)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    policy = cfg.attn_policy()
    if policy not in PORTED_POLICIES:
        raise ValueError(f"policy {policy!r} cannot reconstruct exact "
                         "prefix attention from its cache; use the dense "
                         "engine's one-shot prefill")
    proj = p["pca"]
    hd = cfg.resolved_head_dim
    lay = cfg.page_layout
    pca_store = _stores_pca(policy) or lay.basis == "pca"
    k_store = (torch.einsum("bshd,hde->bshe", k, proj.to(k.dtype))
               if pca_store else k)
    kw = cache["k"].shape[-1]          # the pool's (stored) key width
    k_store = k_store[..., :kw]
    for name, new in (("k", k_store[0]), ("v", v[0])):
        if lay.quantized:
            PC.write_chunk_rows_q(cache[name], cache[name + "_scale"], new,
                                  table_row, pos_start, page_size,
                                  n_valid=n_valid, qmax=lay.qmax)
        else:
            PC.write_chunk_rows(cache[name], new, table_row, pos_start,
                                page_size, n_valid=n_valid)
    klog = PC.gather_logical_dq(cache["k"], cache.get("k_scale"),
                                table_row[None], page_size)
    vlog = PC.gather_logical_dq(cache["v"], cache.get("v_scale"),
                                table_row[None], page_size)
    sl = klog.shape[1]
    scale = hd ** -0.5
    qg = A._group(q, cfg.n_kv_heads)                       # (1,C,Hkv,G,D)
    q_pref = (torch.einsum("bchgd,hde->bchge", qg, proj.to(q.dtype))
              if pca_store else qg)[..., :kw]
    # prefix scores against the cached (storage-basis) keys ...
    scores = torch.einsum("bchgd,bshd->bhgcs", (q_pref * scale).float(),
                          klog.float())
    # ... the chunk's own columns overwritten with fresh original-basis
    # scores; columns of pad rows past the logical length are dropped
    s_chunk = torch.einsum("bchgd,bshd->bhgcs", (qg * scale).float(),
                           k.float())
    n_keep = max(min(c, sl - pos_start), 0)
    scores[..., pos_start:pos_start + n_keep] = s_chunk[..., :n_keep]

    kv_pos = torch.arange(sl, device=x.device)
    mask = kv_pos[None, :] <= positions[0][:, None]        # causal (C, Sl)
    if cfg.sliding_window:
        mask &= positions[0][:, None] - kv_pos[None, :] < cfg.sliding_window
    scores = torch.where(mask[None, None, None], scores, A.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(vlog.dtype)
    o = torch.einsum("bhgcs,bshd->bchgd", w, vlog)
    return L.dot(o.reshape(b, c, cfg.q_dim).to(x.dtype), p["wo"])
