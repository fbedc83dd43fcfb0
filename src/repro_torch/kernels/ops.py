"""Public wrappers over the decode kernels (counterpart of
``repro.kernels.ops``): the single-pass fused Loki decode, the two-kernel
pair, the streaming full decode and the fused exact-top-k decode. Shapes
follow ``fused_decode.fused_loki_decode``; every wrapper takes pooled
caches with ``page_table``/``page_size``."""
from __future__ import annotations

from repro_torch.kernels.fused_decode import (fused_exact_topk_decode,
                                              fused_loki_decode,
                                              select_blocks)
from repro_torch.kernels.gather_attention import (
    block_sparse_attention_grouped, paged_full_decode)


def loki_decode_fused(q_hat, k_hat, v, cur_len, *, d: int, k_blocks: int,
                      block_size: int = 128, scale=None,
                      local_window: int = 0, sliding_window: int = 0,
                      page_table=None, page_size: int = 0,
                      k_scale=None, v_scale=None):
    """Single-pass fused decode: score, select and attend in one kernel; no
    score or selection tensor reaches device memory. Returns (B,Hkv,G,D)."""
    return fused_loki_decode(q_hat, k_hat, v, cur_len, d=d,
                             k_blocks=k_blocks, block_size=block_size,
                             scale=scale, local_window=local_window,
                             sliding_window=sliding_window,
                             page_table=page_table, page_size=page_size,
                             k_scale=k_scale, v_scale=v_scale)


def full_decode(q_hat, k_hat, v, cur_len, *, block_size: int = 128,
                scale=None, sliding_window: int = 0, page_table=None,
                page_size: int = 0, k_scale=None, v_scale=None):
    """Streaming full-attention decode (the ``full`` policy): K/V stream
    block by block, through the page table when paged, into a (G,)-wide
    online softmax, reading only the live prefix (or window)."""
    return paged_full_decode(q_hat, k_hat, v, cur_len,
                             block_size=block_size, scale=scale,
                             sliding_window=sliding_window,
                             page_table=page_table, page_size=page_size,
                             k_scale=k_scale, v_scale=v_scale)


def exact_topk_decode_fused(q_hat, k_hat, v, cur_len, *, k_blocks: int,
                            block_size: int = 128, scale=None,
                            sliding_window: int = 0, page_table=None,
                            page_size: int = 0, k_scale=None, v_scale=None):
    """Single-pass exact-top-k decode: exact full-width scores, block
    top-k and sparse attention in one kernel."""
    return fused_exact_topk_decode(q_hat, k_hat, v, cur_len,
                                   k_blocks=k_blocks, block_size=block_size,
                                   scale=scale,
                                   sliding_window=sliding_window,
                                   page_table=page_table,
                                   page_size=page_size, k_scale=k_scale,
                                   v_scale=v_scale)


def loki_decode_two_kernel(q_hat, k_hat, v, cur_len, *, d: int,
                           k_blocks: int, block_size: int = 128, scale=None,
                           local_window: int = 0, sliding_window: int = 0,
                           page_table=None, page_size: int = 0,
                           k_scale=None, v_scale=None):
    """Two-kernel form: fused score+select (only the (B,Hkv,kb) index rows
    reach device memory) feeding the GQA-batched sparse attention."""
    blk_idx = select_blocks(q_hat, k_hat, cur_len, d=d, k_blocks=k_blocks,
                            block_size=block_size, scale=scale,
                            local_window=local_window,
                            sliding_window=sliding_window,
                            page_table=page_table, page_size=page_size,
                            k_scale=k_scale)
    return block_sparse_attention_grouped(q_hat, k_hat, v, blk_idx, cur_len,
                                          block_size=block_size, scale=scale,
                                          sliding_window=sliding_window,
                                          page_table=page_table,
                                          page_size=page_size,
                                          k_scale=k_scale, v_scale=v_scale)
