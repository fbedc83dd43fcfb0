"""Attention block: params, train forward, prefill and one-token decode.

Counterpart of the attention half of ``repro.models.blocks`` for the dense
contiguous cache. ``pos_len`` is the number of tokens already cached (B,):
the new token lands at that index and RoPE uses it as its position.

Policies in this slice: ``full`` (plain torch only: its kernel is not
ported yet), ``loki`` (token top-k, plain torch as in JAX) and
``loki_block`` (the CUDA kernels through core/dispatch.py).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import dispatch, loki
from repro_torch.models import layers as L

#: policies of the JAX package this slice does not carry, with the
#: ROADMAP item that will
UNPORTED_POLICIES = {
    "exact_topk": "ROADMAP queue 1: exact_topk policy (kernel: queue 2 #5)",
    "pcaattn": "ROADMAP queue 1: pcaattn policy",
    "h2o": "ROADMAP queue 1: h2o policy",
}


def check_policy(cfg: ModelConfig) -> None:
    policy = cfg.attn_policy()
    if policy in UNPORTED_POLICIES:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet "
            f"({UNPORTED_POLICIES[policy]})")
    if policy not in ("full", "loki", "loki_block"):
        raise ValueError(f"unknown attention policy {policy!r}")
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


def attn_decode(p, cache, x, pos_len, cfg: ModelConfig, *,
                sliding_window=None):
    """One-token decode with the configured attention policy.

    x (B,E); pos_len (B,) tokens already cached; cache {"k","v"} of
    (B,Smax,Hkv,D), updated in place. Returns y (B,E)."""
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
    if policy in ("loki", "loki_block"):
        # cache keys live in the PCA basis (paper lines 3-4)
        _, k_store = loki.project_qk(q, k, proj)
    else:
        k_store = k
    _write_cache(cache["k"], k_store, pos_len)
    _write_cache(cache["v"], v, pos_len)

    if policy == "full":
        if dispatch.resolve_backend(cfg.loki.backend,
                                    q.device.type) != "xla":
            raise NotImplementedError(
                "full policy on the kernel backend needs paged_full_decode "
                "(ROADMAP queue 2 #4); use backend='xla'")
        out = A.decode_full(q, cache["k"], cache["v"], cur_len,
                            sliding_window=sw, logit_scale=hd ** -0.5)
    elif policy == "loki":
        out = loki.loki_decode(q, cache["k"], cache["v"], cur_len, proj,
                               cfg.loki, sliding_window=sw)
    elif policy == "loki_block":
        out = dispatch.loki_block_decode(q, cache["k"], cache["v"], cur_len,
                                         proj, cfg.loki, sliding_window=sw)
    else:
        check_policy(cfg)
        raise AssertionError(policy)
    # the plain paths return the cache's dtype (float32 in the dense
    # engine) where the kernels return the query's: both continue in the
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
    if cfg.attn_policy() in ("loki", "loki_block"):
        k_store = torch.einsum("bshd,hde->bshe", k, p["pca"].to(k.dtype))
    else:
        k_store = k
    cache["k"][:, :s] = k_store.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return y
