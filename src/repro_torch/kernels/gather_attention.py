"""Decode attention over selected or live blocks: CUDA kernels and plain
versions.

Counterparts of ``repro.kernels.gather_attention``'s
``block_sparse_attention_grouped`` and ``paged_full_decode`` (the CUDA
source is ``csrc/gather_attention.cu``): exact attention of all G query
heads of a KV group over a group-shared block selection (``-1`` entries of
``blk_idx`` contribute nothing), or over every live block (the ``full``
policy: from the sliding window's first block to ``ceil(cur_len/bs)``).
The per-head ``block_sparse_attention`` is at the end of this module.

  q_hat    (B, Hkv, G, W)    grouped queries in the storage basis (W <= D)
  k_hat    (B, S, Hkv, W)    key cache, or the pool (R, Hkv, W)
  v        (B, S, Hkv, D)    value cache, or the pool (R, Hkv, D)
  blk_idx  (B, Hkv, n_sel)   group-shared selected logical blocks, int32
  cur_len  (B,)
Output:    (B, Hkv, G, D) in q_hat's dtype; all arithmetic in float32.

Paged mode: ``page_table (B, n_tab)`` and ``page_size`` (a multiple of
``block_size``) make the caches pools read through the table; the logical
length is ``n_tab * page_size``. Quantized pools (int8, fp8-e4m3) come
with their (n_pages,) float32 ``k_scale``/``v_scale``: the kernels
stream the codes in chunks that never leave a page and fold its scales in
((q·codes) * K scale, then p * V scale before p·V), the plain versions
dequantize the gathered view. The
wrappers launch the kernels for CUDA tensors and run the plain versions
(over the gathered logical view when paged) for CPU tensors; nothing falls
back from one to the other.

The full decode's kernel is split-KV: each (slot, kv-head)'s live block
range is cut into ``n_split`` equal shares (``split_blocks``, the device's
own formula), each share writes a float32 partial (acc, m, l) and a second
kernel merges them by log-sum-exp. ``full_decode_n_split`` picks n_split
from shapes only. ``full_decode_split_plain`` repeats that arithmetic in
torch for the tests and the card's checks.

The two block-list kernels (grouped and per-head) run as one cluster of C
CTAs per row, C = ``fused_cluster_size`` (shapes only), as the fused
kernels' attention phase runs: the row's entries in [0, S / bs) are kept in
list order, CTA r attends share r of them (``winner_shares``) and CTA 0
merges the C float32 partials by log-sum-exp in rank order.
``grouped_cluster_plain`` and ``head_cluster_plain`` repeat that
arithmetic in torch (``share_partials_plain``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import decode_full
from repro_torch.kernels import _build
from repro_torch.serving.paged_cache import check_scales, gather_logical_dq

NEG_INF = -1e30


def cache_args(k_hat, block_size: int, page_table, page_size: int) -> int:
    """Check a contiguous (B,S,Hkv,W) cache or a paged (R,Hkv,W) pool
    against the kernels' block size; return the logical length S."""
    if page_table is None:
        s_len = k_hat.shape[1]
    else:
        if k_hat.ndim != 3:
            raise ValueError("paged caches are pooled (R, Hkv, W)")
        if page_size <= 0 or page_size % block_size:
            raise ValueError(f"kernel blocks must tile pages exactly: "
                             f"page_size {page_size} is not a multiple of "
                             f"block_size {block_size}")
        s_len = page_table.shape[1] * page_size
    if s_len % block_size:
        raise ValueError("cache length must be a multiple of block_size")
    return s_len


def logical(q_hat, k_hat, v, page_table, page_size: int, k_scale=None,
            v_scale=None):
    """(q_hat, k, v) with pooled caches gathered to their logical
    (B,S,Hkv,·) views, dequantized through the per-page scales of a
    quantized pool (``v`` may be None); contiguous caches pass."""
    if page_table is None:
        return q_hat, k_hat, v
    k_hat = gather_logical_dq(k_hat, k_scale, page_table, page_size)
    if v is not None:
        v = gather_logical_dq(v, v_scale, page_table, page_size)
    return q_hat, k_hat, v


def attend_blocks_plain(q_hat, k_hat, v, blk_idx, cur_len, *, block_size,
                        scale, sliding_window=0):
    """Plain torch version of the attention pass: exact softmax attention
    over the tokens of the listed blocks, masking positions past cur_len,
    outside the sliding window, and of ``-1`` entries; an all-masked row
    gives zeros (the kernels' m_safe / 1e-30 guards)."""
    b, n_kv, g, w = q_hat.shape
    dim = v.shape[-1]
    bs = block_size
    n_sel = blk_idx.shape[-1]
    blk = blk_idx.long()
    tok = (blk.clamp(min=0)[..., None] * bs
           + torch.arange(bs, device=blk.device))       # (B,Hkv,n,bs)
    tok = tok.reshape(b, n_kv, n_sel * bs)
    k_sel = torch.gather(k_hat.transpose(1, 2), 2,
                         tok[..., None].expand(-1, -1, -1, w)).float()
    v_sel = torch.gather(v.transpose(1, 2), 2,
                         tok[..., None].expand(-1, -1, -1, dim)).float()
    s = torch.einsum("bhgw,bhtw->bhgt", q_hat.float() * scale, k_sel)
    cur = cur_len.to(tok.device).long()[:, None, None]
    live = (tok < cur) & (blk >= 0).repeat_interleave(bs, dim=-1)
    if sliding_window:
        live &= tok >= cur - sliding_window
    live = live[:, :, None, :]                          # (B,Hkv,1,T)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe) * live
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v_sel) / l.clamp(min=1e-30)
    return out.to(q_hat.dtype)


def full_decode_plain(q_hat, k_hat, v, cur_len, *, scale,
                      sliding_window=0):
    """Plain torch version of the full-decode kernel: ``decode_full`` over
    the whole (contiguous or gathered) cache in float32, which masks
    positions past cur_len and outside the sliding window."""
    b, n_kv, g, w = q_hat.shape
    out = decode_full(q_hat.reshape(b, n_kv * g, w), k_hat, v.float(),
                      cur_len.to(q_hat.device), sliding_window=sliding_window,
                      logit_scale=scale)
    return out.reshape(b, n_kv, g, v.shape[-1]).to(q_hat.dtype)


#: CTAs per SM the full decode's split count and the cluster size aim at
SPLIT_CTAS_PER_SM = 4


def full_decode_n_split(n_blocks: int, rows: int, n_sm: int) -> int:
    """Splits per (slot, kv-head) of the full decode, from shapes only:
    about SPLIT_CTAS_PER_SM CTAs per SM over ``rows`` = B * Hkv, at least
    1 and at most the ``n_blocks`` = S / block_size blocks of a row. It
    never sees cur_len, so choosing it costs the host no sync."""
    return max(1, min(n_blocks, SPLIT_CTAS_PER_SM * n_sm // max(rows, 1)))


def split_blocks(cur_len, n_blocks: int, block_size: int, n_split: int,
                 sliding_window: int = 0):
    """[first, end) logical blocks of each split, (B, n_split, 2) int64:
    the live range [lo, hi) (the window's first block .. ceil(cur_len /
    bs)) cut into n_split shares of ceil((hi - lo) / n_split) blocks, as
    the kernel computes it from cur_len on the device. Trailing shares may
    be empty."""
    cur = cur_len.long()
    if sliding_window > 0:
        lo = (cur - sliding_window).clamp(min=0) // block_size
    else:
        lo = torch.zeros_like(cur)
    hi = torch.clamp((cur + block_size - 1) // block_size, max=n_blocks)
    per = ((hi - lo).clamp(min=0) + n_split - 1) // n_split
    share = torch.arange(n_split, device=cur.device)
    first = lo[:, None] + share * per[:, None]
    end = torch.minimum(hi[:, None], first + per[:, None])
    return torch.stack([first, torch.maximum(end, first)], dim=-1)


def full_decode_split_plain(q_hat, k_hat, v, cur_len, *, block_size, scale,
                            n_split, sliding_window=0, page_table=None,
                            page_size: int = 0, k_scale=None, v_scale=None):
    """Plain torch version of the split-KV full decode: each split's float32
    partial (acc, m, l) over its share of the live tokens, with the online
    softmax's guards, then the log-sum-exp merge (alpha = 0 for an empty
    partial, the 1e-30 floor). Not on any serving path: the tests and the
    card's checks hold the kernel's arithmetic with it."""
    q_hat, k_hat, v = logical(q_hat, k_hat, v, page_table, page_size,
                              k_scale, v_scale)
    b, n_kv, g, w = q_hat.shape
    s_len = k_hat.shape[1]
    cur = cur_len.to(q_hat.device).long()
    span = split_blocks(cur, s_len // block_size, block_size, n_split,
                        sliding_window)
    pos = torch.arange(s_len, device=q_hat.device)
    live = pos[None] < cur[:, None]
    if sliding_window > 0:
        live &= pos[None] >= (cur - sliding_window)[:, None]
    s = torch.einsum("bhgw,bshw->bhgs", q_hat.float() * scale,
                     k_hat.float())
    vf = v.float()
    parts = []
    for i in range(n_split):
        blk = pos[None] // block_size
        mine = live & (blk >= span[:, i, :1]) & (blk < span[:, i, 1:])
        mine = mine[:, None, None, :]                      # (B,1,1,S)
        si = torch.where(mine, s, NEG_INF)
        m = si.amax(-1)                                    # (B,Hkv,G)
        m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
        p = torch.where(mine, torch.exp(si - m_safe[..., None]), 0.0)
        parts.append((torch.einsum("bhgs,bshd->bhgd", p, vf), m,
                      p.sum(-1)))
    return merge_partials_plain(parts).to(q_hat.dtype)


def fused_cluster_size(n_blocks: int, rows: int, n_sm: int) -> int:
    """CTAs per cluster of the cluster kernels (the two fused kernels,
    block_sparse_attention_grouped, block_sparse_attention), from shapes
    only: about SPLIT_CTAS_PER_SM CTAs per SM over ``rows`` clusters (B *
    Hkv, or BH per head), at least 1 and at most 8 (the portable cluster
    limit) or the ``n_blocks`` = S / block_size blocks of a row. The
    launchers compute the same (``cluster_size`` in
    csrc/decode_common.cuh); it never sees cur_len, so choosing it costs
    the host no sync."""
    return max(1, min(8, n_blocks,
                      SPLIT_CTAS_PER_SM * n_sm // max(rows, 1)))


def winner_shares(n_valid, n_cta: int):
    """[first, end) positions in a block list of the entries each CTA of a
    cluster attends, (..., n_cta, 2) int64: the ``n_valid`` valid entries
    (the fused kernels' winners before the first -1, the block-list
    kernels' entries in [0, S / bs)) cut into n_cta shares of
    ceil(n_valid / n_cta), as the kernels cut them on the device. Trailing
    shares may be empty."""
    nv = n_valid.long()
    per = (nv + n_cta - 1) // n_cta
    share = torch.arange(n_cta, device=nv.device)
    first = torch.minimum(share * per[..., None], nv[..., None])
    end = torch.minimum(first + per[..., None], nv[..., None])
    return torch.stack([first, end], dim=-1)


def share_partials_plain(q_hat, k_hat, v, sel, valid, cur_len, *,
                         block_size, scale, n_cta, sliding_window=0,
                         scale_dot=False):
    """The cluster kernels' attention over a block list, in torch: ``sel``
    (B,Hkv,n) lists logical blocks whose valid entries (``valid``) come
    first, in order; CTA r's float32 partial (acc, m, l) over the live
    tokens of its share of them (``winner_shares``), with the online
    softmax's guards; then the log-sum-exp merge in rank order (alpha = 0
    for an empty partial, the 1e-30 floor). Scores are (q̂ * scale)·k̂, or
    (q̂·k̂) * scale with ``scale_dot`` (the per-head kernel's order)."""
    b, n_kv, g, w = q_hat.shape
    bs, n = block_size, sel.shape[-1]
    dev = q_hat.device
    cur = cur_len.to(dev).long()
    sel = torch.where(valid, sel.long(), 0)
    shares = winner_shares(valid.sum(-1), n_cta)          # (B,Hkv,C,2)
    rank = torch.arange(n, device=dev)
    tpos = sel[..., None] * bs + torch.arange(bs, device=dev)  # (B,Hkv,n,bs)
    live = valid[..., None] & (tpos < cur[:, None, None, None])
    if sliding_window:
        live &= tpos >= (cur - sliding_window)[:, None, None, None]
    flat = tpos.reshape(b, n_kv, n * bs)
    k_sel = torch.gather(k_hat.transpose(1, 2), 2,
                         flat[..., None].expand(-1, -1, -1, w)).float()
    v_sel = torch.gather(v.transpose(1, 2), 2, flat[..., None].expand(
        -1, -1, -1, v.shape[-1])).float()
    if scale_dot:
        s = torch.einsum("bhgw,bhtw->bhgt", q_hat.float(), k_sel) * scale
    else:
        s = torch.einsum("bhgw,bhtw->bhgt", q_hat.float() * scale, k_sel)
    parts = []
    for r in range(n_cta):
        first, end = shares[..., r, :1], shares[..., r, 1:]   # (B,Hkv,1)
        in_r = (rank >= first) & (rank < end)                 # (B,Hkv,n)
        mask = (live & in_r[..., None]).reshape(b, n_kv, 1, -1)
        sr = torch.where(mask, s, NEG_INF)
        m = sr.amax(-1)                                       # (B,Hkv,G)
        m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
        p = torch.where(mask, torch.exp(sr - m_safe[..., None]), 0.0)
        parts.append((torch.einsum("bhgt,bhtd->bhgd", p, v_sel), m,
                      p.sum(-1)))
    return merge_partials_plain(parts).to(q_hat.dtype)


def grouped_cluster_plain(q_hat, k_hat, v, blk_idx, cur_len, *, block_size,
                          scale, n_cta, sliding_window=0, page_table=None,
                          page_size: int = 0, scale_dot=False, k_scale=None,
                          v_scale=None):
    """Plain torch version of block_sparse_attention_grouped's cluster
    form with n_cta CTAs per (slot, kv-head): the entries of blk_idx in
    [0, S / bs) kept in list order (-1 and others contribute nothing),
    then ``share_partials_plain``. Not on any serving path: the tests and
    the card's checks hold the kernel's arithmetic with it."""
    q_hat, k_hat, v = logical(q_hat, k_hat, v, page_table, page_size,
                              k_scale, v_scale)
    nb = k_hat.shape[1] // block_size
    blk = blk_idx.to(q_hat.device).long()
    valid = (blk >= 0) & (blk < nb)
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    return share_partials_plain(
        q_hat, k_hat, v, blk.gather(-1, order), valid.gather(-1, order),
        cur_len, block_size=block_size, scale=scale, n_cta=n_cta,
        sliding_window=sliding_window, scale_dot=scale_dot)


def merge_partials_plain(parts):
    """float32 partials (acc (...,D), m, l) merged by log-sum-exp in list
    order, as the kernels merge them: alpha = 0 for an empty partial
    (m = NEG_INF), the 1e-30 floor on the sum."""
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    m_safe = torch.where(mx <= NEG_INF / 2, 0.0, mx)
    acc = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][2])
    for a, m, l in parts:
        wt = torch.where(m > NEG_INF / 2,
                         torch.exp(torch.clamp(m - m_safe, max=0.0)), 0.0)
        acc = acc + wt[..., None] * a
        den = den + wt * l
    return acc / den.clamp(min=1e-30)[..., None]


_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


_FN: dict = {}
# pointers, then int arguments, then float + int tail of each launcher
# (csrc/gather_attention.cu)
_ARITY = {"loki_block_sparse_attention_grouped": (9, 12),
          "loki_full_decode": (9, 12)}
# argument and result types of the library's shape queries
_QUERIES = {"loki_grouped_cluster_info": ([ctypes.c_int] * 10
                                          + [ctypes.c_void_p], ctypes.c_int),
            "loki_head_cluster_info": ([ctypes.c_int] * 8
                                       + [ctypes.c_void_p], ctypes.c_int),
            "loki_attend_smem_bytes": ([ctypes.c_int] * 6,
                                       ctypes.c_longlong),
            "loki_full_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_longlong),
            "loki_full_decode_info": ([ctypes.c_int] * 6
                                      + [ctypes.c_void_p], ctypes.c_int)}


def _fn(lib: str, name: str):
    """Launcher or query ``name`` of the built library ``lib``, typed."""
    fn = _FN.get((lib, name))
    if fn is None:
        fn = getattr(_build.load(lib), name)
        if name in _QUERIES:
            fn.argtypes, fn.restype = _QUERIES[name]
        else:
            n_ptrs, n_ints = _ARITY[name]
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints
                           + [ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _FN[(lib, name)] = fn
    return fn


def _plan(lib, info_call, code, g, kdim, dim, n_sel, tok) -> dict:
    info = (ctypes.c_longlong * 4)()
    _build.check(info_call(info), "cluster info")
    return dict(C=int(info[0]), smem=int(info[1]), max_clusters=int(info[2]),
                ctas_per_sm=int(info[3]),
                smem_layout=int(_fn(lib, "loki_attend_smem_bytes")(
                    code, g, kdim, dim, n_sel, tok)))


def attend_plan(q_hat, k_hat, v, blk_idx, *, block_size: int = 128,
                page_table=None, page_size: int = 0) -> dict:
    """What block_sparse_attention_grouped's launcher would use at these
    CUDA tensors' shapes, asked from the built library without a launch:
    the cluster size ``C``, the dynamic shared memory ``smem`` (bytes),
    ``max_clusters`` (cudaOccupancyMaxActiveClusters at that memory and
    C), ``ctas_per_sm`` (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
    ``smem_layout`` (the library's ``loki_attend_smem_bytes``). For
    chip_smoke's log and checks."""
    b, n_kv, g, kdim, dim = _widths(q_hat, k_hat, v)
    s_len = cache_args(k_hat, block_size, page_table, page_size)
    n_sel = blk_idx.shape[-1]
    code, _, lib = _build.storage(k_hat, "k_hat")
    return _plan(lib, lambda info: _fn(lib, "loki_grouped_cluster_info")(
        _build.dtype_code(q_hat, "q_hat"), code, b, s_len, n_kv, g, kdim,
        dim, block_size, n_sel, info), code, g, kdim, dim, n_sel, tok=4)


def full_plan(q_hat, k_hat, v, *, block_size: int = 128) -> dict:
    """paged_full_decode's launch at these CUDA tensors' shapes, asked from
    the built library without a launch: ``tokens`` per chunk, ``stage``
    bytes per ring stage, the split kernel's dynamic shared memory
    ``smem`` and ``ctas_per_sm``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at that memory), and
    ``smem_layout``, the library's ``loki_full_smem_bytes``. For
    chip_smoke's log and checks."""
    b, n_kv, g, kdim, dim = _widths(q_hat, k_hat, v)
    code, _, lib = _build.storage(k_hat, "k_hat")
    info = (ctypes.c_longlong * 4)()
    _build.check(_fn(lib, "loki_full_decode_info")(
        _build.dtype_code(q_hat, "q_hat"), code, g, kdim, dim, block_size,
        info), "loki_full_decode_info")
    return dict(tokens=int(info[0]), stage=int(info[1]), smem=int(info[2]),
                ctas_per_sm=int(info[3]),
                smem_layout=int(_fn(lib, "loki_full_smem_bytes")(
                    code, g, kdim, dim)))


def _widths(q_hat, k_hat, v):
    if k_hat.shape[-1] != q_hat.shape[-1]:
        raise ValueError("q_hat/k_hat latent widths must match")
    if q_hat.is_cuda and k_hat.dtype != v.dtype:
        raise TypeError("k_hat and v must share a dtype")
    return q_hat.shape + (v.shape[-1],)


def block_sparse_attention_grouped(q_hat, k_hat, v, blk_idx, cur_len, *,
                                   block_size: int = 128, scale=None,
                                   sliding_window: int = 0,
                                   page_table=None, page_size: int = 0,
                                   k_scale=None, v_scale=None):
    """GQA-batched sparse attention over a group-shared block selection.
    (B,Hkv,G,W),(B,S,Hkv,W),(B,S,Hkv,D),(B,Hkv,n_sel),(B,) -> (B,Hkv,G,D),
    or pooled caches with ``page_table``/``page_size`` (and their per-page
    ``k_scale``/``v_scale`` when quantized). Default scale ``D**-0.5``."""
    check_scales(k_hat, k_scale, v_scale, page_table, page_size)
    b, n_kv, g, kdim, dim = _widths(q_hat, k_hat, v)
    s_len = cache_args(k_hat, block_size, page_table, page_size)
    n_sel = blk_idx.shape[-1]
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return attend_blocks_plain(
            *logical(q_hat, k_hat, v, page_table, page_size, k_scale,
                     v_scale), blk_idx, cur_len, block_size=block_size,
            scale=scale, sliding_window=sliding_window)
    out = torch.empty((b, n_kv, g, dim), dtype=q_hat.dtype,
                      device=q_hat.device)
    table, n_tab = _build.table_arg(page_table, q_hat.device)
    kernel = "block_sparse_attention_grouped"
    code, _, lib = _build.storage_args(kernel, k_hat, v, k_scale is not None)
    ptrs = (_build.cuda_args(kernel, q_hat=q_hat, k_hat=k_hat, v=v,
                             blk_idx=blk_idx.to(torch.int32),
                             cur_len=cur_len.to(torch.int32), table=table)
            + _build.scale_ptrs(kernel, q_hat.device, k_scale, v_scale)
            + _build.cuda_args(kernel, out=out))
    rc = _fn(lib, "loki_block_sparse_attention_grouped")(
        *ptrs, _build.dtype_code(q_hat, "q_hat"), code, b, s_len, n_kv, g,
        kdim, dim, block_size, n_sel, n_tab, page_size, scale,
        sliding_window, _build.stream_of(q_hat))
    _build.check(rc, "block_sparse_attention_grouped")
    block_sparse_attention_grouped.launches += 1
    return out


block_sparse_attention_grouped.launches = 0


def paged_full_decode(q_hat, k_hat, v, cur_len, *, block_size: int = 128,
                      scale=None, sliding_window: int = 0, page_table=None,
                      page_size: int = 0, k_scale=None, v_scale=None):
    """Full-attention decode streamed over the live blocks only (the
    ``full`` policy's kernel), contiguous or paged (with per-page
    ``k_scale``/``v_scale`` when quantized).
    (B,Hkv,G,W),(B,S,Hkv,W),(B,S,Hkv,D),(B,) -> (B,Hkv,G,D) in q_hat's
    dtype. Default scale ``D**-0.5``; cur_len >= 1 per row. On the card
    the live blocks are split ``full_decode_n_split`` ways and merged in
    the same launcher call, through a float32 scratch of
    (B, Hkv, n_split, G, D + 2)."""
    check_scales(k_hat, k_scale, v_scale, page_table, page_size)
    b, n_kv, g, kdim, dim = _widths(q_hat, k_hat, v)
    s_len = cache_args(k_hat, block_size, page_table, page_size)
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return full_decode_plain(
            *logical(q_hat, k_hat, v, page_table, page_size, k_scale,
                     v_scale), cur_len, scale=scale,
            sliding_window=sliding_window)
    out = torch.empty((b, n_kv, g, dim), dtype=q_hat.dtype,
                      device=q_hat.device)
    n_split = full_decode_n_split(s_len // block_size, b * n_kv,
                                  _sm_count(q_hat.device))
    part = torch.empty((b, n_kv, n_split, g, dim + 2), dtype=torch.float32,
                       device=q_hat.device)
    table, n_tab = _build.table_arg(page_table, q_hat.device)
    kernel = "paged_full_decode"
    code, _, lib = _build.storage_args(kernel, k_hat, v, k_scale is not None)
    ptrs = (_build.cuda_args(kernel, q_hat=q_hat, k_hat=k_hat, v=v,
                             cur_len=cur_len.to(torch.int32), table=table)
            + _build.scale_ptrs(kernel, q_hat.device, k_scale, v_scale)
            + _build.cuda_args(kernel, out=out, part=part))
    rc = _fn(lib, "loki_full_decode")(
        *ptrs, _build.dtype_code(q_hat, "q_hat"), code, b, s_len, n_kv, g,
        kdim, dim, block_size, n_tab, page_size, n_split, scale,
        sliding_window, _build.stream_of(q_hat))
    _build.check(rc, "paged_full_decode")
    paged_full_decode.launches += 1
    return out


paged_full_decode.launches = 0


# ------------------------------------------------ per-head sparse attention
#
#   q_hat    (BH, D)        PCA-basis query (full D: exact, Lemma 4.1)
#   k_hat    (BH, S, D)     key cache; token-major, or a (BH, D, S)
#                           feature-major cache seen through
#                           ``.transpose(1, 2)`` (read in place)
#   v        (BH, S, D)
#   blk_idx  (BH, n_sel)    selected blocks, each in [0, S / block_size)
#   cur_len  (BH,)
# Output:    (BH, D) in q_hat's dtype. No -1 sentinel, no window, no page
# table: the JAX function has none.


def block_sparse_attention_plain(q_hat, k_hat, v, blk_idx, cur_len, *,
                                 block_size, scale):
    """Plain torch version (``repro.kernels.ref.block_sparse_attention_
    ref``): softmax attention over the selected blocks' tokens, masking
    positions >= cur_len; a row with no live token gives zeros. The scale
    multiplies the dot, as in the TPU kernel."""
    bh = q_hat.shape[0]
    tok = (blk_idx.long()[..., None] * block_size
           + torch.arange(block_size, device=blk_idx.device)).reshape(bh, -1)
    k_sel = torch.gather(k_hat, 1, tok[..., None].expand(
        -1, -1, k_hat.shape[-1]))
    v_sel = torch.gather(v, 1, tok[..., None].expand(-1, -1, v.shape[-1]))
    s = torch.einsum("bd,bkd->bk", q_hat.float(), k_sel.float()) * scale
    live = tok < cur_len.to(tok.device).long()[:, None]
    w = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    w = torch.where(live.any(-1, keepdim=True), w, 0.0)
    return torch.einsum("bk,bkd->bd", w, v_sel.float()).to(q_hat.dtype)


def key_strides(k_hat):
    """(row, token, feature) element strides of a (BH, S, D) key view the
    kernel reads in place: token-major (feature stride 1) or feature-major
    (token stride 1)."""
    row, tok, feat = k_hat.stride()
    if feat != 1 and tok != 1:
        raise ValueError(f"k_hat strides {k_hat.stride()}: the kernel reads "
                         "a token-major (BH, S, D) cache or a feature-major "
                         "(BH, D, S) one seen through transpose(1, 2)")
    return row, tok, feat


def head_cluster_plain(q_hat, k_hat, v, blk_idx, cur_len, *, block_size,
                       scale, n_cta):
    """Plain torch version of block_sparse_attention's cluster form with
    n_cta CTAs per row: the grouped form at G = 1 over (BH, 1) rows, with
    the dot scaled after it. ``k_hat`` may be a feature-major cache seen
    through ``.transpose(1, 2)``."""
    out = grouped_cluster_plain(
        q_hat[:, None, None], k_hat[:, :, None], v[:, :, None],
        blk_idx[:, None], cur_len, block_size=block_size, scale=scale,
        n_cta=n_cta, scale_dot=True)
    return out.reshape(q_hat.shape)


def head_plan(q_hat, k_hat, blk_idx, *, block_size: int = 128) -> dict:
    """``attend_plan`` for block_sparse_attention's launcher at these CUDA
    tensors' shapes and K̂ layout (token-major, or feature-major seen
    through ``.transpose(1, 2)``)."""
    bh, dim = q_hat.shape
    fm = int(key_strides(k_hat)[2] != 1)
    n_sel = blk_idx.shape[1]
    kv_bf16 = _build.dtype_code(k_hat, "k_hat")
    lib = "gather_attention"
    return _plan(lib, lambda info: _fn(lib, "loki_head_cluster_info")(
        _build.dtype_code(q_hat, "q_hat"), kv_bf16, bh, k_hat.shape[1], dim,
        block_size, n_sel, fm, info), kv_bf16, 1, dim, dim, n_sel,
        tok=16 // k_hat.element_size())


def _head_lib():
    """``loki_block_sparse_attention``: six pointers, seven ints, the three
    64-bit K̂ strides, the scale and the stream."""
    fn = _FN.get("loki_block_sparse_attention")
    if fn is None:
        fn = _build.load("gather_attention").loki_block_sparse_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN["loki_block_sparse_attention"] = fn
    return fn


def block_sparse_attention(q_hat, k_hat, v, blk_idx, cur_len, *,
                           block_size: int = 128, scale=None):
    """Per-head exact attention over each row's selected blocks.
    (BH,D),(BH,S,D),(BH,S,D),(BH,n_sel),(BH,) -> (BH,D) in q_hat's
    dtype. Default scale ``D**-0.5``."""
    bh, dim = q_hat.shape
    if k_hat.shape[0] != bh or k_hat.shape[2] != dim or \
            v.shape != k_hat.shape:
        raise ValueError(f"shapes differ: q_hat {tuple(q_hat.shape)}, k_hat "
                         f"{tuple(k_hat.shape)}, v {tuple(v.shape)}")
    if blk_idx.ndim != 2 or blk_idx.shape[0] != bh or \
            cur_len.shape != (bh,):
        raise ValueError(f"blk_idx {tuple(blk_idx.shape)} / cur_len "
                         f"{tuple(cur_len.shape)} are not (BH, n_sel) / "
                         f"(BH,) with BH = {bh}")
    s_len = k_hat.shape[1]
    if block_size < 1 or s_len % block_size:
        raise ValueError(f"cache length {s_len} must be a multiple of "
                         f"block_size {block_size}")
    k_row, k_tok, k_feat = key_strides(k_hat)
    n_sel = blk_idx.shape[1]
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return block_sparse_attention_plain(q_hat, k_hat, v, blk_idx,
                                            cur_len, block_size=block_size,
                                            scale=scale)
    if k_hat.dtype != v.dtype:
        raise TypeError("k_hat and v must share a dtype")
    if k_hat.device != q_hat.device:
        raise ValueError(f"block_sparse_attention: k_hat is on "
                         f"{k_hat.device}, expected {q_hat.device}")
    out = torch.empty((bh, dim), dtype=q_hat.dtype, device=q_hat.device)
    q_p, v_p, idx_p, len_p, out_p = _build.cuda_args(
        "block_sparse_attention", q_hat=q_hat, v=v,
        blk_idx=blk_idx.to(torch.int32), cur_len=cur_len.to(torch.int32),
        out=out)
    rc = _head_lib()(
        q_p, ctypes.c_void_p(k_hat.data_ptr()), v_p, idx_p, len_p, out_p,
        _build.dtype_code(q_hat, "q_hat"), _build.dtype_code(k_hat, "k_hat"),
        bh, s_len, dim, block_size, n_sel, k_row, k_tok, k_feat, scale,
        _build.stream_of(q_hat))
    _build.check(rc, "block_sparse_attention")
    block_sparse_attention.launches += 1
    return out


block_sparse_attention.launches = 0
