"""GQA-batched block-sparse decode attention: CUDA kernel and plain version.

Counterpart of ``repro.kernels.gather_attention.block_sparse_attention_grouped``
(the CUDA source is ``csrc/gather_attention.cu``). Exact attention of all G
query heads of a KV group over a group-shared block selection; ``-1``
entries of ``blk_idx`` contribute nothing.

  q_hat    (B, Hkv, G, W)    PCA-basis grouped queries (W <= D)
  k_hat    (B, S, Hkv, W)    PCA-basis key cache
  v        (B, S, Hkv, D)
  blk_idx  (B, Hkv, n_sel)   group-shared selected blocks, int32
  cur_len  (B,)
Output:    (B, Hkv, G, D) in q_hat's dtype; all arithmetic in float32.

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def contiguous_only(page_table, k_scale, v_scale) -> None:
    if page_table is not None or k_scale is not None or v_scale is not None:
        raise NotImplementedError("paged kernels: next slice")


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


_FN: dict = {}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _lib():
    fn = _FN.get("fn")
    if fn is None:
        fn = _build.load("gather_attention").loki_block_sparse_attention_grouped
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN["fn"] = fn
    return fn


def block_sparse_attention_grouped(q_hat, k_hat, v, blk_idx, cur_len, *,
                                   block_size: int = 128, scale=None,
                                   sliding_window: int = 0,
                                   page_table=None, page_size: int = 0,
                                   k_scale=None, v_scale=None):
    """GQA-batched sparse attention over a group-shared block selection.
    (B,Hkv,G,W),(B,S,Hkv,W),(B,S,Hkv,D),(B,Hkv,n_sel),(B,) -> (B,Hkv,G,D).
    Default scale ``D**-0.5``."""
    contiguous_only(page_table, k_scale, v_scale)
    b, n_kv, g, kdim = q_hat.shape
    dim = v.shape[-1]
    if k_hat.shape[-1] != kdim:
        raise ValueError("q_hat/k_hat latent widths must match")
    s_len = k_hat.shape[1]
    if s_len % block_size:
        raise ValueError("cache length must be a multiple of block_size")
    n_sel = blk_idx.shape[-1]
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return attend_blocks_plain(q_hat, k_hat, v, blk_idx, cur_len,
                                   block_size=block_size, scale=scale,
                                   sliding_window=sliding_window)
    if k_hat.dtype != v.dtype:
        raise TypeError("k_hat and v must share a dtype")
    out = torch.empty((b, n_kv, g, dim), dtype=q_hat.dtype,
                      device=q_hat.device)
    blk_idx = blk_idx.to(torch.int32)
    cur_len = cur_len.to(torch.int32)
    ptrs = _build.cuda_args("block_sparse_attention_grouped", q_hat=q_hat,
                            k_hat=k_hat, v=v, blk_idx=blk_idx,
                            cur_len=cur_len, out=out)
    fn = _lib()
    rc = fn(*ptrs, _build.dtype_code(q_hat, "q_hat"),
            _build.dtype_code(k_hat, "k_hat"), b, s_len, n_kv, g, kdim, dim,
            block_size, n_sel, scale, sliding_window, _build.stream_of(q_hat))
    _build.check(rc, "block_sparse_attention_grouped")
    block_sparse_attention_grouped.launches += 1
    return out


block_sparse_attention_grouped.launches = 0
