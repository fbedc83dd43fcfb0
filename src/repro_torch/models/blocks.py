"""Attention, MoE and recurrent blocks: params, train forward, prefill and
one-token decode.

Counterpart of ``repro.models.blocks``: attention (the encoder's
non-causal self-attention included) and MoE, and the recurrent blocks of
the hybrid and ssm families (hymba's mamba, xlstm's mLSTM and sLSTM,
whose ``lax.scan`` recurrences run as torch loops over tokens, with their
state in float32 where JAX keeps it). Attention works over the contiguous
cache of the slot engine or the paged pool of the paged engine. ``pos_len``
is the number of tokens already cached (B,): the new token lands at that
index and RoPE uses it as its position. Every attention entry takes the
layer's own ``sliding_window`` (per-layer windows), and the paged ones the
layer's latent-K ``rank`` (per-layer ranks).

Policies: ``full`` and ``exact_topk`` (the CUDA kernels through
core/dispatch.py, or the plain references on backend="xla"), ``loki``
(token top-k, or per-chunk top-k with ``n_chunks``; plain torch as in
JAX), ``loki_block`` (the CUDA kernels through core/dispatch.py), and the
paper's two comparison baselines ``pcaattn`` (truncated PCA keys) and
``h2o`` (a fixed-budget eviction cache), plain torch as in JAX. ``h2o``
and ``pcaattn`` serve through the dense engine only (their caches cannot
rebuild exact prefix attention, ``serving/cache_spec.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import baselines, dispatch, loki
from repro_torch.models import layers as L
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import paged_cache as PC

#: the attention policies the port serves
PORTED_POLICIES = ("full", "exact_topk", "loki", "loki_block", "pcaattn",
                   "h2o")


def check_policy(cfg: ModelConfig) -> None:
    policy = cfg.attn_policy()
    if policy not in PORTED_POLICIES:
        raise ValueError(f"unknown attention policy {policy!r}; the port "
                         f"serves {PORTED_POLICIES}")


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


def attn_train(p, x, positions, cfg: ModelConfig, *, capture=None,
               sliding_window=None):
    """Full causal attention. ``capture``: optional dict that receives the
    pre/post-rotary keys (and post-rotary queries) for PCA calibration.
    ``sliding_window``: this layer's window (``cfg.layer_window``), None
    for ``cfg.sliding_window``."""
    q, k, v = _qkv(p, x, cfg)
    if capture is not None:
        capture["pre"] = k
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    if capture is not None:
        capture["post"] = k
        capture["q"] = q
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    out = A.causal_attention(q, k, v, causal=True, sliding_window=sw)
    b, s = x.shape[:2]
    return L.dot(out.reshape(b, s, cfg.q_dim), p["wo"])


def encoder_attn_train(p, x, cfg: ModelConfig):
    """The encoder's self-attention (whisper): non-causal, no positions
    (the encoder adds sinusoids to its input)."""
    q, k, v = _qkv(p, x, cfg)
    out = A.causal_attention(q, k, v, causal=False)
    b, s = x.shape[:2]
    return L.dot(out.reshape(b, s, cfg.q_dim), p["wo"])


def init_attn_cache(cfg: ModelConfig, batch: int, smax: int, dtype,
                    device, n_layers: int = 1):
    """Zeroed (n_layers, B, Smax, Hkv, D) K and V caches. ``pcaattn``
    keeps only the leading d = max(d_f * D, 8) PCA dims of each key;
    ``h2o`` keeps its budgeted state (``baselines.H2OState``: k, v, pos,
    acc, fill, each stacked on n_layers, batch second) with a budget of
    ``loki.static_k`` tokens."""
    check_policy(cfg)
    hd, n_kv = cfg.resolved_head_dim, cfg.n_kv_heads
    policy = cfg.attn_policy()
    if policy == "h2o":
        budget = loki.static_k(cfg.loki, smax)
        st = baselines.h2o_init(n_layers * batch, budget, n_kv, hd, dtype,
                                device=device)
        return {name: t.reshape((n_layers, batch) + t.shape[1:])
                for name, t in st._asdict().items()}
    kw = max(int(cfg.loki.d_f * hd), 8) if policy == "pcaattn" else hd
    lead = (n_layers, batch, smax, n_kv)
    return {"k": torch.zeros(lead + (kw,), dtype=dtype, device=device),
            "v": torch.zeros(lead + (hd,), dtype=dtype, device=device)}


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
                sliding_window=None, page_table=None, page_size: int = 0,
                frame_table=None, plan_rows=None, n_rows=None, rank=None):
    """One-token decode with the configured attention policy.

    x (B,E); pos_len (B,) tokens already cached; cache {"k","v"} of
    (B,Smax,Hkv,·), or with ``page_table (B, max_pages)``/``page_size``
    the paged pools (R,Hkv,·): the new token's K/V scatter through the
    table to their pool rows. Updated in place. Returns y (B,E).

    ``frame_table (B, max_pages)`` (tiered pools, Loki policies): the K/V
    rows live at device frames and the always-resident ``k_lat`` sidecar
    by logical page. The K/V rows are written through the frame table,
    the sidecar's through the page table; the score pass reads the
    sidecar and exact attention the frames (``dispatch.
    loki_tiered_decode``). Returns (y, winners (B, max_pages) bool), the
    logical pages the selection attended.

    ``plan_rows`` (an int, the engine's slots x kv heads): the rows the
    kernels' split count and cluster size are planned for
    (``dispatch``), so a gather-packed step launches each slot as the
    full-width step does. ``n_rows`` (an int): only x's first n_rows rows
    are the step's (``pos_len`` and the tables have n_rows rows); the
    rest pad the row-wise projections to the engine's width
    (``lm.decode_step``) and leave as zeros.

    ``h2o`` (contiguous caches only) inserts into, attends over and
    updates its budgeted state in place; ``pcaattn`` stores the leading
    d PCA dims of each key.

    ``sliding_window``: this layer's window, overriding
    ``cfg.sliding_window`` (per-layer windows, ``cfg.window_layers``; 0 =
    full attention). ``rank`` (an int): this layer's latent-K rank under
    ``cfg.page_ranks``; the pool is as wide as the widest layer and the
    stored keys' columns from ``rank`` on are zeroed (they add nothing to
    q̂·k̂)."""
    hd = cfg.resolved_head_dim
    rows = x.shape[0]
    b = rows if n_rows is None else n_rows
    q, k, v = _qkv(p, x[:, None, :], cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]          # (rows,H,D)/(rows,Hkv,D)
    positions = pos_len.expand(b)
    if cfg.rope:
        pos_rows = F.pad(positions, (0, rows - b))
        q = L.apply_rope(q[:, None], pos_rows[:, None],
                         cfg.rope_theta)[:, 0]
        k = L.apply_rope(k[:, None], pos_rows[:, None],
                         cfg.rope_theta)[:, 0]

    policy = cfg.attn_policy()
    proj = p["pca"]

    def out_rows(out):
        """The attention output (B,H,·) through wo, over all x's rows."""
        out = out.reshape(b, cfg.q_dim).to(x.dtype)
        return L.dot(F.pad(out, (0, 0, 0, rows - b)), p["wo"])
    cur_len = positions + 1                       # cache incl. new token
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    paged = page_table is not None
    lay = cfg.page_layout
    if policy == "h2o":
        if paged:
            raise ValueError("h2o keeps its own budgeted cache; serve it "
                             "through the dense engine")
        st = baselines.H2OState(cache["k"], cache["v"], cache["pos"],
                                cache["acc"], cache["fill"])
        out, _ = baselines.h2o_decode(q[:b], k[:b], v[:b], st, positions,
                                      inplace=True)
        return out_rows(out)
    if _stores_pca(policy):
        _, k_store = loki.project_qk(q, k, proj)
    elif policy == "pcaattn":
        d = cache["k"].shape[-1]
        k_store = torch.einsum("bhd,hde->bhe", k, proj[..., :d].to(k.dtype))
    elif paged and lay.basis == "pca":
        # latent-basis pages for full / exact_topk: store k̂ = k·P and
        # rotate q at read time (exact at full rank, Lemma 4.1)
        k_store = torch.einsum("bhd,hde->bhe", k, proj.to(k.dtype))
    else:
        k_store = k
    # the latent-basis query of full / exact_topk, over all rows too
    q_read = q
    if paged and lay.basis == "pca" and policy in ("full", "exact_topk"):
        qg = q.reshape(rows, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                       hd)
        qh = torch.einsum("bhgd,hde->bhge", qg, proj.to(q.dtype))
        q_read = qh[..., :lay.k_width(hd)].reshape(rows, cfg.n_heads, -1)
    q, k_store, v, q_read = q[:b], k_store[:b], v[:b], q_read[:b]
    scales = {}
    if paged:
        # the pool's width is the stored key width: rank-r truncation
        kw = cache["k"].shape[-1]
        k_store = k_store[..., :kw]
        if rank is not None:
            k_store = _rank_masked(k_store, rank)
        if frame_table is not None:
            if cfg.loki.n_chunks:
                raise ValueError("tiered pools do not support chunked "
                                 "(distributed) Loki selection")
            out, win = _attn_decode_tiered(cache, q, k_store, v, positions,
                                           proj, cfg, sw, page_table,
                                           page_size, frame_table, x.dtype)
            return out_rows(out), win
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
    kargs = dict(pargs, plan_rows=plan_rows)

    # queries follow the storage basis (q_read above); hd**-0.5 stays the
    # logit scale when the stored key width is the latent rank r < hd
    if policy == "full":
        out = dispatch.full_paged_decode(q_read, cache["k"], cache["v"],
                                         cur_len, backend=cfg.loki.backend,
                                         block_size=cfg.loki.block_size,
                                         sliding_window=sw,
                                         logit_scale=hd ** -0.5, **kargs)
    elif policy == "exact_topk":
        out = dispatch.exact_topk_paged_decode(q_read, cache["k"],
                                               cache["v"], cur_len, cfg.loki,
                                               logit_scale=hd ** -0.5,
                                               **kargs)
    elif policy == "loki":
        kc, vc = dispatch.gathered(cache["k"], cache["v"], **pargs)
        fn = loki.loki_decode_chunked if cfg.loki.n_chunks else \
            loki.loki_decode
        out = fn(q, kc, vc, cur_len, proj, cfg.loki, sliding_window=sw)
    elif policy == "loki_block":
        out = dispatch.loki_block_decode(q, cache["k"], cache["v"], cur_len,
                                         proj, cfg.loki, sliding_window=sw,
                                         **kargs)
    elif policy == "pcaattn":
        kc, vc = dispatch.gathered(cache["k"], cache["v"], **pargs)
        out = baselines.pcaattn_decode(q, kc, vc, cur_len, proj, cfg.loki)
    else:
        check_policy(cfg)
        raise AssertionError(policy)
    # the plain paths return the cache's dtype (float32 in both engines)
    # where the kernels return the query's: both continue in the
    # activation dtype (a no-op when the model computes in float32)
    return out_rows(out)


def _attn_decode_tiered(cache, q, k_store, v, positions, proj,
                        cfg: ModelConfig, sw, page_table, page_size: int,
                        frame_table, act_dtype):
    """The tiered half of ``attn_decode``: writes, then the score pass over
    the sidecar and exact attention over the frames -> (out (B,H,D) in
    ``act_dtype``, winners)."""
    policy = cfg.attn_policy()
    if policy not in ("loki", "loki_block"):
        raise ValueError("tiered pools serve Loki policies only "
                         f"(got {policy!r})")
    dl = cache["k_lat"].shape[-1]
    PC.write_token_rows(cache["k"], k_store, frame_table, positions,
                        page_size)
    PC.write_token_rows(cache["v"], v, frame_table, positions, page_size)
    PC.write_token_rows(cache["k_lat"], k_store[..., :dl], page_table,
                        positions, page_size)
    out, win = dispatch.loki_tiered_decode(
        q, cache["k"], cache["v"], cache["k_lat"], positions + 1, proj,
        cfg.loki, sliding_window=sw, page_table=page_table,
        frame_table=frame_table, page_size=page_size,
        token_granular=policy == "loki")
    return out.to(act_dtype), win


def _rank_masked(k_store, rank: int):
    """Stored keys with their columns from ``rank`` on zeroed (a layer's
    own rank in a pool as wide as the widest layer's)."""
    keep = torch.arange(k_store.shape[-1], device=k_store.device) < rank
    return k_store * keep.to(k_store.dtype)


def attn_prefill(p, cache, x, positions, cfg: ModelConfig, *,
                 sliding_window=None):
    """Process a whole prompt, writing cache rows [0, S) in place. The
    cache stores keys in the policy's basis so decode steps are pure
    Algorithm 1 (``pcaattn``: the leading d PCA dims). ``h2o`` keeps the
    most recent ``budget`` prompt tokens and resets its state. Returns
    y. ``sliding_window``: this layer's window, None for
    ``cfg.sliding_window``."""
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    out = A.causal_attention(q, k, v, causal=True, sliding_window=sw)
    b, s = x.shape[:2]
    y = L.dot(out.reshape(b, s, cfg.q_dim), p["wo"])
    policy = cfg.attn_policy()
    if policy == "h2o":
        # budget cache: keep the most recent `budget` prompt tokens
        budget = cache["k"].shape[1]
        take = min(budget, s)
        for name, new in (("k", k), ("v", v)):
            cache[name].zero_()
            cache[name][:, :take] = new[:, s - take:].to(cache[name].dtype)
        cache["pos"].fill_(-1)
        cache["pos"][:, :take] = torch.arange(s - take, s, dtype=torch.int32,
                                              device=x.device)
        cache["acc"].zero_()
        cache["fill"].fill_(take)
        return y
    if _stores_pca(policy):
        k_store = torch.einsum("bshd,hde->bshe", k, p["pca"].to(k.dtype))
    elif policy == "pcaattn":
        d = cache["k"].shape[-1]
        k_store = torch.einsum("bshd,hde->bshe", k,
                               p["pca"][..., :d].to(k.dtype))
    else:
        k_store = k
    cache["k"][:, :s] = k_store.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return y


def attn_prefill_chunk(p, cache, x, pos_start: int, n_valid: int,
                       cfg: ModelConfig, *, table_row, page_size: int,
                       frame_row=None, rank=None, sliding_window=None):
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
    fresh original-basis keys, as the one-shot prefill does.

    ``frame_row (max_pages,)`` (tiered pools): each table entry's device
    frame. Prefill is exact attention over the whole prefix, so the
    scheduler has made every page of the slot resident; K/V rows are
    written and read through the frames, the ``k_lat`` sidecar written
    through ``table_row``.

    ``sliding_window`` and ``rank``: this layer's window and latent-K
    rank, as ``attn_decode`` takes them."""
    b, c = x.shape[:2]
    q, k, v = _qkv(p, x, cfg)
    positions = pos_start + torch.arange(c, device=x.device)[None]  # (1,C)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    policy = cfg.attn_policy()
    if policy in CS.UNPAGEABLE_POLICIES:
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
    if rank is not None:
        k_store = _rank_masked(k_store, rank)
    kv_row = table_row if frame_row is None else frame_row
    for name, new in (("k", k_store[0]), ("v", v[0])):
        if lay.quantized:
            PC.write_chunk_rows_q(cache[name], cache[name + "_scale"], new,
                                  table_row, pos_start, page_size,
                                  n_valid=n_valid, qmax=lay.qmax)
        else:
            PC.write_chunk_rows(cache[name], new, kv_row, pos_start,
                                page_size, n_valid=n_valid)
    if frame_row is not None:
        PC.write_chunk_rows(cache["k_lat"],
                            k_store[0][..., :cache["k_lat"].shape[-1]],
                            table_row, pos_start, page_size, n_valid=n_valid)
    klog = PC.gather_logical_dq(cache["k"], cache.get("k_scale"),
                                kv_row[None], page_size)
    vlog = PC.gather_logical_dq(cache["v"], cache.get("v_scale"),
                                kv_row[None], page_size)
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
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    if sw:
        mask &= positions[0][:, None] - kv_pos[None, :] < sw
    scores = torch.where(mask[None, None, None], scores, A.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(vlog.dtype)
    o = torch.einsum("bhgcs,bshd->bchgd", w, vlog)
    return L.dot(o.reshape(b, c, cfg.q_dim).to(x.dtype), p["wo"])


# =====================================================================
# MoE block (capacity dispatch; FLOPs track active experts)
# =====================================================================

#: tokens per dispatch group (keeps dispatch tensors small)
MOE_GROUP = 256


def init_moe(gen, cfg: ModelConfig, *, dtype, device, n_layers):
    """Router (float32, as the JAX code uses it) and the stacked expert
    matrices, drawn from ``gen`` like every other leaf."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    gated = cfg.mlp in ("swiglu", "geglu")
    kw = dict(device=device, n_layers=n_layers)
    return {"router": L._init(gen, (d, m.n_experts), dtype=torch.float32,
                              **kw),
            "w_in": L._init(gen, (m.n_experts, d, 2 * f if gated else f),
                            dtype=dtype, **kw),
            "w_out": L._init(gen, (m.n_experts, f, d), dtype=dtype, **kw)}


def _expert_act(h, cfg: ModelConfig, f: int):
    if cfg.mlp in ("swiglu", "geglu"):
        gate, up = h[..., :f], h[..., f:]
        # jax.nn.gelu defaults to the tanh approximation
        act = (F.silu(gate) if cfg.mlp == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        return act * up
    if cfg.mlp == "sq_relu":
        return torch.relu(h).square()
    return F.gelu(h, approximate="tanh")


def _route(x, p, top_k: int):
    """Router logits (float32), softmax probabilities and the top-k gates
    renormalised over the k picks, ties to the lower expert
    (``lax.top_k``'s order)."""
    logits = L.dot(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_w, eidx = loki.topk_lower_index(probs, top_k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_w, eidx


def moe_apply(p, x, cfg: ModelConfig):
    """x (B,S,E) -> (y (B,S,E), aux loss). Capacity routing with
    sort-based gather/scatter dispatch over groups of MOE_GROUP tokens.

    Tokens are sorted by expert id with a stable sort, so an expert over
    capacity drops its latest tokens (GShard's drop-in-token-order); each
    expert's capacity window gathers its tokens, and the combine is a
    scatter-add of the gated expert outputs. The aux loss is the Switch
    load balance plus ``router_z_loss`` times the router z-loss.

    A token count above MOE_GROUP must be a multiple of it: the reference
    reshapes to (n_tok // g, g, E), which is undefined otherwise, so this
    raises a ValueError rather than pad."""
    m = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    g = min(MOE_GROUP, n_tok)
    if n_tok % g:
        raise ValueError(f"moe_apply: {n_tok} tokens are not a whole "
                         f"number of {MOE_GROUP}-token dispatch groups")
    n_groups = n_tok // g
    xt = x.reshape(n_groups, g, d)
    K, E = m.top_k, m.n_experts
    dev = x.device
    logits, probs, gate_w, eidx = _route(xt, p, K)          # (G,g,K)

    cap = int(math.ceil(g * K / E * m.capacity_factor))
    cap = max(4, -(-cap // 4) * 4)                          # round up to 4

    # ---- sort-based dispatch --------------------------------------------
    flat_e = eidx.reshape(n_groups, g * K)                  # (G,gK)
    flat_w = gate_w.reshape(n_groups, g * K)
    order = torch.sort(flat_e, dim=-1, stable=True).indices  # by expert
    sorted_e = torch.gather(flat_e, -1, order).contiguous()
    erange = torch.arange(E, device=dev).expand(n_groups, E).contiguous()
    starts = torch.searchsorted(sorted_e, erange, side="left")
    ends = torch.searchsorted(sorted_e, erange, side="right")
    slot = starts[:, :, None] + torch.arange(cap, device=dev)  # (G,E,C)
    valid = (slot < ends[:, :, None]).reshape(n_groups, -1)   # drops
    slot = torch.clamp(slot, max=g * K - 1)
    sel = torch.gather(order, -1, slot.reshape(n_groups, -1))  # (G,E*C)
    tok = sel // K
    w_sel = torch.where(valid, torch.gather(flat_w, -1, sel), 0.0)

    dt = x.dtype
    x_sel = torch.gather(xt, 1, tok[..., None].expand(-1, -1, d))
    expert_in = x_sel.reshape(n_groups, E, cap, d)
    h = torch.einsum("gecd,edf->gecf", expert_in, p["w_in"].to(dt))
    h = _expert_act(h, cfg, m.d_ff_expert)
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))

    # ---- combine: gated scatter-add back to token order ------------------
    # one index_add_ per pick rank k: a token holds at most one pick of
    # each rank, so no call adds two terms into one row and the sum runs
    # in rank order on any device (atomics make one call's order free)
    contrib = expert_out.reshape(n_groups, E * cap, d) \
        * w_sel[..., None].to(dt)
    rows = (tok + g * torch.arange(n_groups, device=dev)[:, None]).reshape(-1)
    rank = (sel % K).reshape(-1)
    contrib = contrib.reshape(-1, d)
    y = torch.zeros((n_tok, d), dtype=dt, device=dev)
    for k in range(K):
        mine = rank == k
        y.index_add_(0, torch.where(mine, rows, 0),
                     torch.where(mine[:, None], contrib, 0.0))
    y = y.reshape(b, s, d)

    # aux: load balance (Switch) + router z-loss
    first = F.one_hot(eidx[:, :, 0], E).float()
    frac_tokens = first.mean(dim=1)                         # first choice
    frac_probs = probs.mean(dim=1)
    lb = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y, lb + m.router_z_loss * zl


def moe_decode(p, x, cfg: ModelConfig):
    """Single-token MoE: x (B,E) -> (B,E), the top-k experts' weights
    gathered per token (no capacity: every pick is served)."""
    m = cfg.moe
    _, _, gate_w, eidx = _route(x, p, m.top_k)              # (B,K)
    dt = x.dtype
    w_in = p["w_in"][eidx].to(dt)                           # (B,K,E,f')
    w_out = p["w_out"][eidx].to(dt)
    h = torch.einsum("bd,bkdf->bkf", x, w_in)
    h = _expert_act(h, cfg, m.d_ff_expert)
    y = torch.einsum("bkf,bkfd->bkd", h, w_out)
    return torch.einsum("bk,bkd->bd", gate_w.to(dt), y)


# =====================================================================
# Mamba (S6) block: hymba's SSM heads, in parallel with its attention
# =====================================================================

#: tokens whose decay and input terms one pass of ``_mamba_scan`` forms at
#: once; the recurrence itself runs token by token, one kernel a token
MAMBA_SCAN_BLOCK = 256


def init_mamba(gen, cfg: ModelConfig, *, dtype, device, n_layers=None):
    """The S6 block's leaves: in/out projections, the depthwise conv, the
    x and dt projections, ``a_log = log(1..N)`` per channel (float32, as
    JAX reads it), zero dt bias and unit skip (at ``dtype``, as JAX casts
    them at use)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = max(d // 16, 1)
    kw = dict(dtype=dtype, device=device, n_layers=n_layers)
    lead = () if n_layers is None else (n_layers,)
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, s.state_dim + 1, **f32).expand(d_in, s.state_dim)
    return {"in_proj": L._init(gen, (d, 2 * d_in), **kw),
            "conv_w": L._init(gen, (s.conv_width, d_in), scale=0.5, **kw),
            "x_proj": L._init(gen, (d_in, dt_rank + 2 * s.state_dim), **kw),
            "dt_proj": L._init(gen, (dt_rank, d_in), **kw),
            "dt_bias": torch.zeros(lead + (d_in,), dtype=dtype,
                                   device=device),
            "a_log": torch.log(a).expand(lead + a.shape).contiguous(),
            "d_skip": torch.ones(lead + (d_in,), dtype=dtype, device=device),
            "out_proj": L._init(gen, (d_in, d), **kw)}


def _softplus(x):
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0) (torch's own
    switches to x above a threshold)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp(x, min=0)


def _mamba_scan(p, xz, conv_state, ssm_state, cfg: ModelConfig,
                n_valid=None):
    """The shared S6 recurrence. xz (B,S,2*d_in) from in_proj; conv_state
    (B,cw-1,d_in), ssm_state (B,d_in,N) float32. Returns (y (B,S,d_in),
    the new conv window, the new float32 state); the inputs are not
    written.

    ``n_valid`` (an int): positions at or past it are padding (a prefill
    chunk's tail). Their dt is 0, so the state passes through them (exp(0)
    = 1, zero input), and the carried conv window ends at the last valid
    token: chunks run back to back give the unchunked recurrence.

    JAX's ``lax.scan`` over tokens becomes a loop: per block of
    ``MAMBA_SCAN_BLOCK`` tokens the decays exp(dt·A) and inputs dt·x·B are
    formed at once, then each token's state is one fused multiply-add
    (h = dA·h + dBx), and the outputs contract the block's states with C
    at once. The state and its terms are float32, as in JAX."""
    s = cfg.ssm
    d_in = xz.shape[-1] // 2
    x, z = xz[..., :d_in], xz[..., d_in:]
    cw = s.conv_width
    n_tok = x.shape[1]
    xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    if cw <= 1:
        new_conv = conv_state
    elif n_valid is None:
        new_conv = xpad[:, -(cw - 1):]
    else:
        # the last cw-1 inputs ending at the n_valid-th real token (rows
        # [n_valid, n_valid + cw - 1) of xpad; back into the old window
        # when the chunk holds fewer than cw-1 real tokens)
        new_conv = xpad[:, n_valid:n_valid + cw - 1]
    conv = sum(xpad[:, i:i + n_tok] * p["conv_w"][i] for i in range(cw))
    x = F.silu(conv)

    dt_rank = p["dt_proj"].shape[0]
    n = s.state_dim
    proj = L.dot(x, p["x_proj"])
    dt = _softplus(L.dot(proj[..., :dt_rank], p["dt_proj"]) + p["dt_bias"])
    if n_valid is not None:
        dt = dt * (torch.arange(n_tok, device=x.device)
                   < n_valid)[None, :, None]
    a = -torch.exp(p["a_log"].float())                        # (d_in,N)
    xf, dtf = x.float(), dt.float()
    bf = proj[..., dt_rank:dt_rank + n].float()               # (B,S,N)
    cf = proj[..., dt_rank + n:].float()
    h = ssm_state.float()
    ys = []
    for t0 in range(0, n_tok, MAMBA_SCAN_BLOCK):
        t1 = min(n_tok, t0 + MAMBA_SCAN_BLOCK)
        da = torch.exp(dtf[:, t0:t1, :, None] * a)            # (B,T,d_in,N)
        dbx = (dtf[:, t0:t1] * xf[:, t0:t1])[..., None] \
            * bf[:, t0:t1, None, :]
        hs = []
        for t in range(t1 - t0):
            h = torch.addcmul(dbx[:, t], da[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, 1),
                               cf[:, t0:t1]))
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + x * p["d_skip"]
    y = y * F.silu(z)
    return y, new_conv, h


def mamba_train(p, x, cfg: ModelConfig):
    """The S6 block over (B,S,E) from a zero state."""
    y, _ = mamba_prefill(p, x, cfg)
    return y


def mamba_prefill(p, x, cfg: ModelConfig):
    """The S6 block over a whole prompt (B,S,E) from a zero state ->
    (y (B,S,E), the final {conv, ssm}: the conv window in x's dtype, as
    JAX's ``_mamba_prefill`` leaves it)."""
    s = cfg.ssm
    b = x.shape[0]
    d_in = s.expand * cfg.d_model
    xz = L.dot(x, p["in_proj"])
    conv0 = torch.zeros((b, s.conv_width - 1, d_in), dtype=x.dtype,
                        device=x.device)
    ssm0 = torch.zeros((b, d_in, s.state_dim), dtype=torch.float32,
                       device=x.device)
    y, conv, ssm = _mamba_scan(p, xz, conv0, ssm0, cfg)
    return L.dot(y, p["out_proj"]), {"conv": conv, "ssm": ssm}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     n_layers=None):
    """Zero {conv (B,cw-1,d_in) in ``dtype``, ssm (B,d_in,N) float32},
    stacked on ``n_layers`` when given."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    lead = () if n_layers is None else (n_layers,)
    return {"conv": torch.zeros(lead + (batch, s.conv_width - 1, d_in),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, d_in, s.state_dim),
                               dtype=torch.float32, device=device)}


def mamba_decode(p, state, x, cfg: ModelConfig):
    """One token x (B,E) from ``state`` {conv, ssm} -> (y (B,E), the new
    state, conv in the state's dtype)."""
    xz = L.dot(x[:, None, :], p["in_proj"])
    y, conv, ssm = _mamba_scan(p, xz, state["conv"], state["ssm"], cfg)
    return (L.dot(y[:, 0], p["out_proj"]),
            {"conv": conv.to(state["conv"].dtype), "ssm": ssm})


def mamba_prefill_chunk(p, state, x, n_valid: int, cfg: ModelConfig):
    """One chunk of a chunked prefill: x (1,C,E), the first ``n_valid``
    real, from the slot's carried ``state``. Pad tokens leave the state as
    it was, so consecutive chunks give the one-shot prefill's state.
    Returns (y (1,C,E), the new state)."""
    xz = L.dot(x, p["in_proj"])
    y, conv, ssm = _mamba_scan(p, xz, state["conv"], state["ssm"], cfg,
                               n_valid=n_valid)
    return (L.dot(y, p["out_proj"]),
            {"conv": conv.to(state["conv"].dtype), "ssm": ssm})


# =====================================================================
# xLSTM blocks: mLSTM (chunkwise parallel) and sLSTM (recurrent)
# =====================================================================

#: tokens per chunk of the chunkwise-parallel mLSTM
MLSTM_CHUNK = 256


def init_mlstm(gen, cfg: ModelConfig, *, dtype, device):
    """One mLSTM layer's leaves: q/k/v, the output gate and projection,
    and the input/forget gate pre-activations (``w_if`` and ``b_if``, the
    forget bias 3, float32: JAX's decode reads them at float32)."""
    d = cfg.d_model
    nh = cfg.ssm.n_heads
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {"wq": L._init(gen, (d, d), **kw),
            "wk": L._init(gen, (d, d), **kw),
            "wv": L._init(gen, (d, d), **kw),
            "w_if": L._init(gen, (d, 2 * nh), scale=0.01, **f32),
            "b_if": torch.cat([torch.zeros(nh, **f32),
                               3.0 * torch.ones(nh, **f32)]),
            "wo_gate": L._init(gen, (d, d), **kw),
            "w_out": L._init(gen, (d, d), **kw)}


def mlstm_train(p, x, cfg: ModelConfig, *, return_state: bool = False,
                initial_state=None, n_valid=None):
    """Chunkwise-parallel mLSTM (exponentially gated linear attention with
    a matrix memory) over x (B,S,E), chunks of ``MLSTM_CHUNK`` (the whole
    sequence when S is not a multiple). ``return_state``: also return the
    final {C, n, m}, the chunk loop's own carry. ``initial_state``: resume
    from a carried {C, n, m} (the paged engine's chunked prefill).
    ``n_valid`` (an int): positions at or past it are padding, their input
    gate -1e30 and forget gate 1, so they add nothing to the carry."""
    b, s, d = x.shape
    nh = cfg.ssm.n_heads
    dh = d // nh
    dt = x.dtype
    q = L.dot(x, p["wq"]).reshape(b, s, nh, dh) * dh ** -0.5
    k = L.dot(x, p["wk"]).reshape(b, s, nh, dh) * dh ** -0.5
    v = L.dot(x, p["wv"]).reshape(b, s, nh, dh)
    # gate pre-activations: the activation-dtype matmul accumulated in
    # float32 (products of two bf16 values are exact in float32)
    if_g = torch.matmul(x.float(), p["w_if"].to(dt).float()) + p["b_if"]
    ig, logf = if_g[..., :nh], F.logsigmoid(if_g[..., nh:])   # (B,S,H)
    if n_valid is not None:
        vm = (torch.arange(s, device=x.device) < n_valid)[None, :, None]
        ig = torch.where(vm, ig, -1e30)                       # i -> 0
        logf = torch.where(vm, logf, 0.0)                     # f -> 1

    c = min(MLSTM_CHUNK, s)
    if s % c:
        c = s
    if initial_state is not None:
        C = initial_state["C"].float()
        n = initial_state["n"].float()
        m = initial_state["m"].float()
    else:
        C = torch.zeros((b, nh, dh, dh), dtype=torch.float32,
                        device=x.device)
        n = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
        m = torch.full((b, nh), -1e30, dtype=torch.float32, device=x.device)
    tmask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    hs = []
    for c0 in range(0, s, c):
        qq, kk, vv = q[:, c0:c0 + c], k[:, c0:c0 + c], v[:, c0:c0 + c]
        ii, ff = ig[:, c0:c0 + c], logf[:, c0:c0 + c]        # (B,c,H)
        csum = torch.cumsum(ff, dim=1)                       # sum_{j<=t}
        total = csum[:, -1]                                  # (B,H)
        # intra-chunk log weights a[t,s] = csum_t - csum_s + i_s (s <= t)
        log_a = csum[:, :, None, :] - csum[:, None, :, :] + ii[:, None]
        log_a = torch.where(tmask[None, :, :, None], log_a, -math.inf)
        # inter-chunk: the carried state decayed to position t
        log_b = csum + m[:, None, :]                         # (B,t,H)
        m_new = torch.maximum(log_a.amax(dim=2), log_b)
        a = torch.exp(log_a - m_new[:, :, None, :])
        bw = torch.exp(log_b - m_new)
        scores = torch.einsum("bthd,bshd->bhts", qq.float(), kk.float())
        scores = scores * a.permute(0, 3, 1, 2)              # (B,H,t,s)
        num_intra = torch.einsum("bhts,bshd->bthd", scores.to(dt), vv)
        num_inter = torch.einsum("bthd,bhde->bthe", qq, C.to(dt)) \
            * bw[..., None].to(dt)
        den = (torch.einsum("bthd,bhd->bth", qq.float(), n) * bw
               + scores.sum(dim=3).transpose(1, 2))
        h = (num_intra + num_inter).float() / torch.maximum(
            den.abs(), torch.exp(-m_new))[..., None]
        hs.append(h.to(dt))
        # the carry: C' = exp(total + m - m') C
        #                 + sum_s exp(total - csum_s + i_s - m') k v^T
        m_next = torch.maximum(total + m,
                               (total[:, None] - csum + ii).amax(dim=1))
        decay_c = torch.exp(total + m - m_next)              # (B,H)
        w_s = torch.exp(total[:, None] - csum + ii - m_next[:, None])
        C = (C * decay_c[..., None, None]
             + torch.einsum("bsh,bshd,bshe->bhde", w_s, kk.float(),
                            vv.float()))
        n = (n * decay_c[..., None]
             + torch.einsum("bsh,bshd->bhd", w_s, kk.float()))
        m = m_next
    h = torch.cat(hs, dim=1).reshape(b, s, d)
    o = torch.sigmoid(L.dot(x, p["wo_gate"]))
    y = L.dot(h * o, p["w_out"])
    if return_state:
        return y, {"C": C, "n": n, "m": m}
    return y


def init_mlstm_cache(cfg: ModelConfig, batch: int, device):
    """Zero {C (B,H,dh,dh), n (B,H,dh)} and m (B,H) at -1e30, float32."""
    nh = cfg.ssm.n_heads
    dh = cfg.d_model // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, dh, dh), **f32),
            "n": torch.zeros((batch, nh, dh), **f32),
            "m": torch.full((batch, nh), -1e30, **f32)}


def mlstm_decode(p, state, x, cfg: ModelConfig):
    """One token x (B,E) from ``state`` {C, n, m} -> (y (B,E), the new
    state); the gates in float32."""
    b, d = x.shape
    nh = cfg.ssm.n_heads
    dh = d // nh
    dt = x.dtype
    q = L.dot(x, p["wq"]).reshape(b, nh, dh) * dh ** -0.5
    k = L.dot(x, p["wk"]).reshape(b, nh, dh) * dh ** -0.5
    v = L.dot(x, p["wv"]).reshape(b, nh, dh)
    if_g = L.dot(x.float(), p["w_if"].float()) + p["b_if"]
    ii, ff = if_g[..., :nh], F.logsigmoid(if_g[..., nh:])
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(ff + m, ii)
    fw = torch.exp(ff + m - m_new)[..., None]
    iw = torch.exp(ii - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = C * fw[..., None] + iw[..., None] * kf[..., None] * vf[:, :, None, :]
    n = n * fw + iw * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(dt).reshape(b, d)
    o = torch.sigmoid(L.dot(x, p["wo_gate"]))
    return L.dot(h * o, p["w_out"]), {"C": C, "n": n, "m": m_new}


def init_slstm(gen, cfg: ModelConfig, *, dtype, device):
    """One sLSTM layer's leaves: the input part of the z, i, f, o gates,
    the per-head recurrent matrices (float32, as the cell reads them), a
    zero gate bias and the output projection."""
    d = cfg.d_model
    nh = cfg.ssm.n_heads
    dh = d // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"w_gates": L._init(gen, (d, 4 * d), dtype=dtype, device=device),
            "r_gates": L._init(gen, (nh, dh, 4 * dh), scale=0.1, **f32),
            "b_gates": torch.zeros((4 * d,), **f32),
            "w_out": L._init(gen, (d, d), dtype=dtype, device=device)}


def _slstm_cell(p, wx_t, state, nh: int, dh: int):
    """One sLSTM step; ``wx_t`` (B,4d) is the input part, float32. The
    recurrent part (B,H,4dh) is laid out head by head and added to the
    gate-major input part as JAX's reshape lays it."""
    c, n, h, m = state
    b = wx_t.shape[0]
    rh = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, dh),
                      p["r_gates"]).reshape(b, 4 * nh * dh)
    pre = (wx_t + rh + p["b_gates"]).float()
    d = nh * dh
    z = torch.tanh(pre[:, :d])
    i_p, f_p = pre[:, d:2 * d], pre[:, 2 * d:3 * d]
    o = torch.sigmoid(pre[:, 3 * d:])
    logf = F.logsigmoid(f_p)
    m_new = torch.maximum(logf + m, i_p)
    i_w = torch.exp(i_p - m_new)
    f_w = torch.exp(logf + m - m_new)
    c = f_w * c + i_w * z
    n = f_w * n + i_w
    h = o * (c / torch.clamp(n, min=1.0))
    return c, n, h, m_new


def slstm_train(p, x, cfg: ModelConfig, *, return_state: bool = False,
                initial_state=None, n_valid=None):
    """The sLSTM recurrence over x (B,S,E), token by token (JAX's scan).
    ``initial_state``/``n_valid``: resume from a carried {c, n, h, m} and
    leave the state alone at pad positions (the paged engine's chunked
    prefill); a pad position's output is the last valid one's h."""
    b, s, d = x.shape
    nh = cfg.ssm.n_heads
    dh = d // nh
    wx = torch.matmul(x.float(), p["w_gates"].float())      # (B,S,4d)
    if initial_state is not None:
        st = tuple(initial_state[k].float() for k in ("c", "n", "h", "m"))
    else:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        st = (zeros, zeros, zeros, torch.full((b, d), -1e30,
                                              dtype=torch.float32,
                                              device=x.device))
    n_run = s if n_valid is None else min(int(n_valid), s)
    hs = []
    for t in range(n_run):
        st = _slstm_cell(p, wx[:, t], st, nh, dh)
        hs.append(st[2])
    hs += [st[2]] * (s - n_run)
    h = torch.stack(hs, dim=1).to(x.dtype)
    y = L.dot(h, p["w_out"])
    if return_state:
        c, n, hst, m = st
        return y, {"c": c, "n": n, "h": hst, "m": m}
    return y


def init_slstm_cache(cfg: ModelConfig, batch: int, device):
    """Zero {c, n, h} (B,d) and m (B,d) at -1e30, float32."""
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch, cfg.d_model), **f32)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, cfg.d_model), -1e30, **f32)}


def slstm_decode(p, state, x, cfg: ModelConfig):
    """One token x (B,E) from ``state`` {c, n, h, m} -> (y, new state)."""
    nh = cfg.ssm.n_heads
    dh = cfg.d_model // nh
    wx = torch.matmul(x.float(), p["w_gates"].float())
    c, n, h, m = _slstm_cell(p, wx, tuple(state[k] for k in
                                          ("c", "n", "h", "m")), nh, dh)
    y = L.dot(h.to(x.dtype), p["w_out"])
    return y, {"c": c, "n": n, "h": h, "m": m}
