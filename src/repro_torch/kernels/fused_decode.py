"""Fused GQA-batched Loki decode: CUDA kernels and plain versions.

Counterparts of ``repro.kernels.fused_decode.fused_loki_decode``,
``fused_exact_topk_decode`` and ``select_blocks`` (the CUDA source is
``csrc/fused_decode.cu``). For each (batch, kv-head) pair:

  1. score: q̂[:d]·k̂[:d] for every live token of every query head of the
     group; a block's score is the maximum over its tokens and the G heads.
     Positions past cur_len (or before the sliding window) are NEG_INF; the
     local window's live positions get +1e4 so they always win.
  2. select: ``k_blocks`` rounds of argmax-and-suppress over the block
     scores, ties to the lower index (``lax.top_k``'s order); ``-1`` once
     no block with a finite score is left.
  3. attend (fused only): exact softmax attention over the winning blocks.

  q_hat    (B, Hkv, G, W)   PCA-basis queries, W = stored key width <= D
  k_hat    (B, S, Hkv, W)   key cache in the PCA basis
  v        (B, S, Hkv, D)
  cur_len  (B,)             >= 1 per row (the decode invariant; unchecked)

``fused_exact_topk_decode`` is the fused pass at d = W without the recency
boost: selection over exact full-width scores (the ``exact_topk`` policy).

Paged mode: with ``page_table (B, n_tab)`` and ``page_size`` the caches
are the serving engine's pools (R, Hkv, ·) and the logical length is
``n_tab * page_size``; the kernels resolve every block through the table,
the plain versions gather the logical view first. ``page_size`` must be a
multiple of ``block_size``.

Quantized pools (int8, fp8-e4m3) come with their (n_pages,) float32
``k_scale``/``v_scale`` (select_blocks takes ``k_scale`` alone; paged
only): the score pass dequantizes a row as it reads it, code -> float32 *
page scale, then takes the dot, as the plain versions do over the
gathered view (so the block maxima are theirs); the attention pass folds
the page's scales in, (q·codes) * K scale and p * V scale before p·V.
fp16 pools carry no scales.

Default scales differ as in the JAX package: ``D**-0.5`` for the fused
kernels, ``W**-0.5`` for select_blocks. The wrappers launch the kernels for
CUDA tensors and run the plain versions for CPU tensors.

On the card the two fused kernels run as one cluster of C CTAs per (slot,
kv-head): CTA r scores share r of the live blocks (``split_blocks``), every
CTA runs the same top-k over the whole row of block maxima, CTA r attends
share r of the winners (``winner_shares``) and CTA 0 merges the C partials
by log-sum-exp in rank order. select_blocks runs the first two phases
alone, on the same clusters, and CTA 0 writes the winners; its block
maxima and winners are the fused kernels' bits at any C.
``fused_cluster_size`` (in ``gather_attention``, shared with the
block-list kernels) is the launchers' rule for C (shapes only), planned
for ``plan_rows`` rows (B * Hkv, or the engine's full width under
gather-packed decode: ``gather_attention``'s docstring);
``fused_cluster_plain`` repeats the cluster form's arithmetic in torch for
the tests and the card's checks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.loki import topk_lower_index
from repro_torch.kernels import _build
from repro_torch.kernels.gather_attention import (NEG_INF,
                                                  attend_blocks_plain,
                                                  cache_args,
                                                  fused_cluster_size,
                                                  logical, plan_rows_of,
                                                  share_partials_plain,
                                                  split_blocks,
                                                  winner_shares)
from repro_torch.serving.paged_cache import check_scales


def token_scores_plain(q_hat, k_hat, cur_len, *, d, scale, local_window=0,
                       sliding_window=0):
    """(B,Hkv,S) float32 token scores: the group max of q̂[:d]·k̂[:d],
    NEG_INF outside cur_len and the sliding window, +1e4 in the local
    window."""
    s_len = k_hat.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q_hat[..., :d].float() * scale,
                     k_hat[..., :d].float()).amax(2)     # (B,Hkv,S)
    pos = torch.arange(s_len, device=s.device)
    cur = cur_len.to(s.device).long()[:, None, None]
    live = pos < cur
    if sliding_window:
        live &= pos >= cur - sliding_window
    s = torch.where(live, s, NEG_INF)
    if local_window:
        s = torch.where(live & (pos >= cur - local_window), s + 1e4, s)
    return s


def block_scores_plain(q_hat, k_hat, cur_len, *, d, block_size, scale,
                       local_window=0, sliding_window=0):
    """Phase 1: the (B,Hkv,nb) float32 block scores selection runs on."""
    b, s_len, n_kv, _ = k_hat.shape
    s = token_scores_plain(q_hat, k_hat, cur_len, d=d, scale=scale,
                           local_window=local_window,
                           sliding_window=sliding_window)
    return s.reshape(b, n_kv, s_len // block_size, block_size).amax(-1)


def select_blocks_plain(q_hat, k_hat, cur_len, *, d, k_blocks, block_size,
                        scale, local_window=0, sliding_window=0):
    """Plain torch version of phases 1-2 -> (B,Hkv,kb) int32 with ``-1``
    sentinels. A stable descending sort cut to kb is argmax-and-suppress
    with ties to the lower index."""
    blk = block_scores_plain(q_hat, k_hat, cur_len, d=d,
                             block_size=block_size, scale=scale,
                             local_window=local_window,
                             sliding_window=sliding_window)
    taken, idx = topk_lower_index(blk, k_blocks)
    return torch.where(taken > NEG_INF / 2, idx, -1).to(torch.int32)


def fused_loki_decode_plain(q_hat, k_hat, v, cur_len, *, d, k_blocks,
                            block_size, scale, local_window=0,
                            sliding_window=0):
    """Plain torch version of the fused kernel -> (B,Hkv,G,D)."""
    sel = select_blocks_plain(q_hat, k_hat, cur_len, d=d, k_blocks=k_blocks,
                              block_size=block_size, scale=scale,
                              local_window=local_window,
                              sliding_window=sliding_window)
    return attend_blocks_plain(q_hat, k_hat, v, sel, cur_len,
                               block_size=block_size, scale=scale,
                               sliding_window=sliding_window)


def fused_cluster_plain(q_hat, k_hat, v, cur_len, *, d, k_blocks,
                        block_size, scale, n_cta, local_window=0,
                        sliding_window=0, page_table=None,
                        page_size: int = 0, k_scale=None, v_scale=None):
    """Plain torch version of the fused kernels' cluster form with n_cta
    CTAs per (slot, kv-head): each CTA's block maxima over its share of
    the live blocks, assembled into one row; the shared top-k over that
    row; each CTA's float32 partial (acc, m, l) over its share of the
    winners' live tokens, with the online softmax's guards; then the
    log-sum-exp merge in rank order (alpha = 0 for an empty partial, the
    1e-30 floor). ``fused_exact_topk_decode``'s form is d = W with
    local_window 0. Not on any serving path: the tests and the card's
    checks hold the kernel's arithmetic with it."""
    q_hat, k_hat, v = logical(q_hat, k_hat, v, page_table, page_size,
                              k_scale, v_scale)
    b, n_kv, g, w = q_hat.shape
    s_len, bs = k_hat.shape[1], block_size
    nb = s_len // bs
    k_blocks = min(k_blocks, nb)
    cur = cur_len.to(q_hat.device).long()
    # 1. score: each CTA's block maxima over its own share of the blocks
    tok = token_scores_plain(q_hat, k_hat, cur, d=d, scale=scale,
                             local_window=local_window,
                             sliding_window=sliding_window)
    span = split_blocks(cur, nb, bs, n_cta, sliding_window)   # (B,C,2)
    blk = torch.arange(nb, device=q_hat.device)
    pos_blk = torch.arange(s_len, device=q_hat.device) // bs
    row = torch.full((b, n_kv, nb), NEG_INF, device=q_hat.device)
    for r in range(n_cta):
        lo, hi = span[:, r, :1], span[:, r, 1:]               # (B,1)
        mine = (pos_blk >= lo) & (pos_blk < hi)               # (B,S)
        part = torch.where(mine[:, None], tok, NEG_INF)
        part = part.reshape(b, n_kv, nb, bs).amax(-1)
        owned = ((blk >= lo) & (blk < hi))[:, None]           # (B,1,nb)
        row = torch.where(owned, part, row)
    # 2. select: the same top-k over the whole row in every CTA
    taken, idx = topk_lower_index(row, k_blocks)
    # 3-4. attend: CTA r's partial over its share of the winners, merged
    # in rank order
    return share_partials_plain(q_hat, k_hat, v, idx, taken > NEG_INF / 2,
                                cur, block_size=bs, scale=scale, n_cta=n_cta,
                                sliding_window=sliding_window)


def _outputs(kernel, q_hat, k_hat, v, cur_len, page_table, dim, k_scale,
             v_scale):
    """The (B,Hkv,G,D) output, the storage code and the launch pointers q,
    k, v, cur_len, table, k_scale, v_scale, out of a fused kernel,
    checked."""
    if k_hat.dtype != v.dtype:
        raise TypeError("k_hat and v must share a dtype")
    code = _build.storage_args(kernel, k_hat, v, k_scale is not None)[0]
    b, n_kv, g, _ = q_hat.shape
    out = torch.empty((b, n_kv, g, dim), dtype=q_hat.dtype,
                      device=q_hat.device)
    table, n_tab = _build.table_arg(page_table, q_hat.device)
    ptrs = (_build.cuda_args(kernel, q_hat=q_hat, k_hat=k_hat, v=v,
                             cur_len=cur_len.to(torch.int32), table=table)
            + _build.scale_ptrs(kernel, q_hat.device, k_scale, v_scale)
            + _build.cuda_args(kernel, out=out))
    return out, code, ptrs, n_tab


def fused_exact_topk_decode_plain(q_hat, k_hat, v, cur_len, *, k_blocks,
                                  block_size, scale, sliding_window=0):
    """Plain torch version of the exact-top-k kernel: the fused pass with
    d = W and no recency boost."""
    return fused_loki_decode_plain(q_hat, k_hat, v, cur_len,
                                   d=q_hat.shape[-1], k_blocks=k_blocks,
                                   block_size=block_size, scale=scale,
                                   local_window=0,
                                   sliding_window=sliding_window)


_FN: dict = {}
# pointers, then int arguments, of each launcher (csrc/fused_decode.cu)
_ARITY = {"loki_fused_decode": (8, 14, 2),
          "loki_fused_exact_topk_decode": (8, 13, 1),
          "loki_select_blocks": (6, 13, 2)}
# argument and result types of the library's shape queries
_QUERIES = {"loki_fused_cluster_info": ([ctypes.c_int] * 12
                                        + [ctypes.c_void_p], ctypes.c_int),
            "loki_fused_smem_bytes": ([ctypes.c_int] * 8,
                                      ctypes.c_longlong),
            "loki_select_cluster_info": ([ctypes.c_int] * 11
                                         + [ctypes.c_void_p], ctypes.c_int),
            "loki_select_smem_bytes": ([ctypes.c_int] * 6,
                                       ctypes.c_longlong)}


def _fn(lib: str, name: str):
    """Launcher or query ``name`` of the built library ``lib``, typed."""
    fn = _FN.get((lib, name))
    if fn is None:
        fn = getattr(_build.load(lib), name)
        if name in _QUERIES:
            fn.argtypes, fn.restype = _QUERIES[name]
        else:
            n_ptrs, n_ints, n_tail = _ARITY[name]
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints + [ctypes.c_float]
                           + [ctypes.c_int] * n_tail + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _FN[(lib, name)] = fn
    return fn


def _plan(lib, info_name, info_args, smem_name, smem_args) -> dict:
    """A cluster launcher's plan asked from library ``lib``: C, shared
    memory, resident clusters and resident CTAs per SM from ``info_name``,
    and ``smem_layout`` from the layout query ``smem_name``."""
    info = (ctypes.c_longlong * 4)()
    _build.check(_fn(lib, info_name)(*info_args, info), info_name)
    return dict(C=int(info[0]), smem=int(info[1]),
                max_clusters=int(info[2]), ctas_per_sm=int(info[3]),
                smem_layout=int(_fn(lib, smem_name)(*smem_args)))


def cluster_plan(q_hat, k_hat, v, *, d: int, k_blocks: int,
                 block_size: int = 128, page_table=None,
                 page_size: int = 0) -> dict:
    """What the fused launcher would use at these CUDA tensors' shapes
    (``d`` = W for the exact-top-k kernel), asked from the built library
    without a launch: the cluster size ``C``, the dynamic shared memory
    ``smem`` (bytes), ``max_clusters`` (cudaOccupancyMaxActiveClusters at
    that memory and C) and ``ctas_per_sm``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), plus ``smem_layout``,
    the library's
    ``loki_fused_smem_bytes`` at the same shape. For chip_smoke's log and
    checks."""
    b, n_kv, g, kdim, s_len, k_blocks = _shape(q_hat, k_hat, block_size,
                                               k_blocks, page_table,
                                               page_size)
    code, lib, _ = _build.storage(k_hat, "k_hat")
    dim = v.shape[-1]
    return _plan(lib, "loki_fused_cluster_info",
                 (_build.dtype_code(q_hat, "q_hat"), code, b, s_len, n_kv, g,
                  kdim, dim, d, block_size, k_blocks, b * n_kv),
                 "loki_fused_smem_bytes",
                 (code, g, kdim, dim, d, block_size, s_len // block_size,
                  k_blocks))


def select_plan(q_hat, k_hat, *, d: int, k_blocks: int,
                block_size: int = 128, page_table=None,
                page_size: int = 0) -> dict:
    """``cluster_plan`` for select_blocks' launcher: ``C``, ``smem``,
    ``max_clusters`` and ``smem_layout`` (the library's
    ``loki_select_smem_bytes``). For chip_smoke's log and checks."""
    b, n_kv, g, kdim, s_len, k_blocks = _shape(q_hat, k_hat, block_size,
                                               k_blocks, page_table,
                                               page_size)
    code, lib, _ = _build.storage(k_hat, "k_hat")
    return _plan(lib, "loki_select_cluster_info",
                 (_build.dtype_code(q_hat, "q_hat"), code, b, s_len, n_kv, g,
                  kdim, d, block_size, k_blocks, b * n_kv),
                 "loki_select_smem_bytes",
                 (code, g, kdim, d, block_size, s_len // block_size))


def _shape(q_hat, k_hat, block_size, k_blocks, page_table, page_size):
    b, n_kv, g, kdim = q_hat.shape
    if k_hat.shape[-1] != kdim:
        raise ValueError("q_hat/k_hat latent widths must match")
    s_len = cache_args(k_hat, block_size, page_table, page_size)
    return b, n_kv, g, kdim, s_len, min(k_blocks, s_len // block_size)


def _launch(name, counter, ptrs, q_hat, k_hat, code, ints,
            floats_and_tail):
    fn = _fn(_build.storage(k_hat, name)[1], name)
    rc = fn(*ptrs, _build.dtype_code(q_hat, "q_hat"), code, *ints,
            *floats_and_tail, _build.stream_of(q_hat))
    _build.check(rc, counter.__name__)
    counter.launches += 1


def fused_loki_decode(q_hat, k_hat, v, cur_len, *, d: int, k_blocks: int,
                      block_size: int = 128, scale=None,
                      local_window: int = 0, sliding_window: int = 0,
                      page_table=None, page_size: int = 0,
                      k_scale=None, v_scale=None, plan_rows=None):
    """Single-pass Loki decode. (B,Hkv,G,W),(B,S,Hkv,W),(B,S,Hkv,D),(B,)
    (or pooled (R,Hkv,·) caches with ``page_table``/``page_size``, and
    their per-page ``k_scale``/``v_scale`` when quantized) -> (B,Hkv,G,D)
    in q_hat's dtype. On the card: one launch of ``fused_cluster_size``
    CTAs per (slot, kv-head), as one cluster, planned for ``plan_rows``."""
    check_scales(k_hat, k_scale, v_scale, page_table, page_size)
    b, n_kv, g, kdim, s_len, k_blocks = _shape(q_hat, k_hat, block_size,
                                               k_blocks, page_table,
                                               page_size)
    dim = v.shape[-1]
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return fused_loki_decode_plain(
            *logical(q_hat, k_hat, v, page_table, page_size, k_scale,
                     v_scale), cur_len, d=d, k_blocks=k_blocks,
            block_size=block_size, scale=scale, local_window=local_window,
            sliding_window=sliding_window)
    out, code, ptrs, n_tab = _outputs("fused_loki_decode", q_hat, k_hat, v,
                                      cur_len, page_table, dim, k_scale,
                                      v_scale)
    _launch("loki_fused_decode", fused_loki_decode, ptrs, q_hat, k_hat,
            code, (b, s_len, n_kv, g, kdim, dim, d, block_size, k_blocks,
                   n_tab, page_size, plan_rows_of(plan_rows, b, n_kv)),
            (scale, local_window, sliding_window))
    return out


fused_loki_decode.launches = 0


def fused_exact_topk_decode(q_hat, k_hat, v, cur_len, *, k_blocks: int,
                            block_size: int = 128, scale=None,
                            sliding_window: int = 0, page_table=None,
                            page_size: int = 0, k_scale=None, v_scale=None,
                            plan_rows=None):
    """Single-pass exact-top-k decode: exact full-width block scores,
    group-shared block top-k and attention over the winners in one
    kernel. Shapes, paging, scales and ``plan_rows`` follow
    ``fused_loki_decode``; no
    recency boost. -> (B,Hkv,G,D) in q_hat's dtype."""
    check_scales(k_hat, k_scale, v_scale, page_table, page_size)
    b, n_kv, g, kdim, s_len, k_blocks = _shape(q_hat, k_hat, block_size,
                                               k_blocks, page_table,
                                               page_size)
    dim = v.shape[-1]
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return fused_exact_topk_decode_plain(
            *logical(q_hat, k_hat, v, page_table, page_size, k_scale,
                     v_scale), cur_len, k_blocks=k_blocks,
            block_size=block_size, scale=scale,
            sliding_window=sliding_window)
    out, code, ptrs, n_tab = _outputs("fused_exact_topk_decode", q_hat,
                                      k_hat, v, cur_len, page_table, dim,
                                      k_scale, v_scale)
    _launch("loki_fused_exact_topk_decode", fused_exact_topk_decode, ptrs,
            q_hat, k_hat, code, (b, s_len, n_kv, g, kdim, dim, block_size,
                                 k_blocks, n_tab, page_size,
                                 plan_rows_of(plan_rows, b, n_kv)),
            (scale, sliding_window))
    return out


fused_exact_topk_decode.launches = 0


def select_blocks(q_hat, k_hat, cur_len, *, d: int, k_blocks: int,
                  block_size: int = 128, scale=None, local_window: int = 0,
                  sliding_window: int = 0, page_table=None,
                  page_size: int = 0, k_scale=None, plan_rows=None):
    """Fused score+select: (B,Hkv,G,W),(B,S,Hkv,W) or pooled (with the K
    pool's ``k_scale`` when quantized),(B,) -> (B,Hkv,kb) int32 logical
    block indices, group-shared, ``-1`` for exhausted entries. On the card:
    one launch of ``fused_cluster_size`` CTAs per (slot, kv-head), as one
    cluster (``select_plan``), planned for ``plan_rows``."""
    check_scales(k_hat, k_scale, None, page_table, page_size, need_v=False)
    b, n_kv, g, kdim, s_len, k_blocks = _shape(q_hat, k_hat, block_size,
                                               k_blocks, page_table,
                                               page_size)
    scale = float(scale if scale is not None else kdim ** -0.5)
    if not q_hat.is_cuda:
        q_hat, k_hat, _ = logical(q_hat, k_hat, None, page_table, page_size,
                                  k_scale)
        return select_blocks_plain(
            q_hat, k_hat, cur_len, d=d, k_blocks=k_blocks,
            block_size=block_size, scale=scale, local_window=local_window,
            sliding_window=sliding_window)
    code = _build.storage_args("select_blocks", k_hat, None,
                               k_scale is not None)[0]
    out = torch.empty((b, n_kv, k_blocks), dtype=torch.int32,
                      device=q_hat.device)
    table, n_tab = _build.table_arg(page_table, q_hat.device)
    ptrs = (_build.cuda_args("select_blocks", q_hat=q_hat, k_hat=k_hat,
                             cur_len=cur_len.to(torch.int32), table=table)
            + _build.scale_ptrs("select_blocks", q_hat.device, k_scale)
            + _build.cuda_args("select_blocks", out=out))
    _launch("loki_select_blocks", select_blocks, ptrs, q_hat, k_hat, code,
            (b, s_len, n_kv, g, kdim, d, block_size, k_blocks, n_tab,
             page_size, plan_rows_of(plan_rows, b, n_kv)),
            (scale, local_window, sliding_window))
    return out


select_blocks.launches = 0
