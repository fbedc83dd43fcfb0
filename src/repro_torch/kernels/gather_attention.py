"""GQA-batched decode attention: CUDA kernels and plain versions.

Counterparts of ``repro.kernels.gather_attention``'s
``block_sparse_attention_grouped`` and ``paged_full_decode`` (the CUDA
source is ``csrc/gather_attention.cu``). Exact attention of all G query
heads of a KV group over a group-shared block selection (``-1`` entries of
``blk_idx`` contribute nothing), or over every live block (the ``full``
policy: from the sliding window's first block to ``ceil(cur_len/bs)``).

  q_hat    (B, Hkv, G, W)    grouped queries in the storage basis (W <= D)
  k_hat    (B, S, Hkv, W)    key cache, or the pool (R, Hkv, W)
  v        (B, S, Hkv, D)    value cache, or the pool (R, Hkv, D)
  blk_idx  (B, Hkv, n_sel)   group-shared selected logical blocks, int32
  cur_len  (B,)
Output:    (B, Hkv, G, D) in q_hat's dtype; all arithmetic in float32.

Paged mode: ``page_table (B, n_tab)`` and ``page_size`` (a multiple of
``block_size``) make the caches pools read through the table; the logical
length is ``n_tab * page_size``. The wrappers launch the kernels for CUDA
tensors and run the plain versions (over the gathered logical view when
paged) for CPU tensors; nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import decode_full
from repro_torch.kernels import _build
from repro_torch.serving.paged_cache import gather_logical, unscaled

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


def logical(q_hat, k_hat, v, page_table, page_size: int):
    """(q_hat, k, v) with pooled caches gathered to their logical
    (B,S,Hkv,·) views (``v`` may be None); contiguous caches pass."""
    if page_table is None:
        return q_hat, k_hat, v
    k_hat = gather_logical(k_hat, page_table, page_size)
    if v is not None:
        v = gather_logical(v, page_table, page_size)
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


_FN: dict = {}
# pointers, then int arguments, then float + int tail of each launcher
_ARITY = {"loki_block_sparse_attention_grouped": (7, 12),
          "loki_full_decode": (6, 11)}


def _lib(name):
    fn = _FN.get(name)
    if fn is None:
        n_ptrs, n_ints = _ARITY[name]
        fn = getattr(_build.load("gather_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


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
    or pooled caches with ``page_table``/``page_size``. Default scale
    ``D**-0.5``."""
    unscaled(k_scale, v_scale)
    b, n_kv, g, kdim, dim = _widths(q_hat, k_hat, v)
    s_len = cache_args(k_hat, block_size, page_table, page_size)
    n_sel = blk_idx.shape[-1]
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return attend_blocks_plain(
            *logical(q_hat, k_hat, v, page_table, page_size), blk_idx,
            cur_len, block_size=block_size, scale=scale,
            sliding_window=sliding_window)
    out = torch.empty((b, n_kv, g, dim), dtype=q_hat.dtype,
                      device=q_hat.device)
    table, n_tab = _build.table_arg(page_table, q_hat.device)
    ptrs = _build.cuda_args("block_sparse_attention_grouped", q_hat=q_hat,
                            k_hat=k_hat, v=v,
                            blk_idx=blk_idx.to(torch.int32),
                            cur_len=cur_len.to(torch.int32), table=table,
                            out=out)
    rc = _lib("loki_block_sparse_attention_grouped")(
        *ptrs, _build.dtype_code(q_hat, "q_hat"),
        _build.dtype_code(k_hat, "k_hat"), b, s_len, n_kv, g, kdim, dim,
        block_size, n_sel, n_tab, page_size, scale, sliding_window,
        _build.stream_of(q_hat))
    _build.check(rc, "block_sparse_attention_grouped")
    block_sparse_attention_grouped.launches += 1
    return out


block_sparse_attention_grouped.launches = 0


def paged_full_decode(q_hat, k_hat, v, cur_len, *, block_size: int = 128,
                      scale=None, sliding_window: int = 0, page_table=None,
                      page_size: int = 0, k_scale=None, v_scale=None):
    """Full-attention decode streamed over the live blocks only (the
    ``full`` policy's kernel), contiguous or paged.
    (B,Hkv,G,W),(B,S,Hkv,W),(B,S,Hkv,D),(B,) -> (B,Hkv,G,D) in q_hat's
    dtype. Default scale ``D**-0.5``; cur_len >= 1 per row."""
    unscaled(k_scale, v_scale)
    b, n_kv, g, kdim, dim = _widths(q_hat, k_hat, v)
    s_len = cache_args(k_hat, block_size, page_table, page_size)
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return full_decode_plain(
            *logical(q_hat, k_hat, v, page_table, page_size), cur_len,
            scale=scale, sliding_window=sliding_window)
    out = torch.empty((b, n_kv, g, dim), dtype=q_hat.dtype,
                      device=q_hat.device)
    table, n_tab = _build.table_arg(page_table, q_hat.device)
    ptrs = _build.cuda_args("paged_full_decode", q_hat=q_hat, k_hat=k_hat,
                            v=v, cur_len=cur_len.to(torch.int32),
                            table=table, out=out)
    rc = _lib("loki_full_decode")(
        *ptrs, _build.dtype_code(q_hat, "q_hat"),
        _build.dtype_code(k_hat, "k_hat"), b, s_len, n_kv, g, kdim, dim,
        block_size, n_tab, page_size, scale, sliding_window,
        _build.stream_of(q_hat))
    _build.check(rc, "paged_full_decode")
    paged_full_decode.launches += 1
    return out


paged_full_decode.launches = 0
