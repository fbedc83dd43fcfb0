"""Public wrappers over the Loki decode kernels (counterpart of
``repro.kernels.ops``): the single-pass fused decode and the two-kernel
pair. Shapes follow ``fused_decode.fused_loki_decode``."""
from __future__ import annotations

from repro_torch.kernels.fused_decode import fused_loki_decode, select_blocks
from repro_torch.kernels.gather_attention import \
    block_sparse_attention_grouped


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
