"""Public wrappers over the kernels (counterpart of ``repro.kernels.ops``).

The per-head pipeline of the paper, over flattened (BH) rows:

  1. block_max_scores kernel       approximate scores from the leading d
                                   PCA dims -> (BH, S/bs) block maxima
  2. top-k over the block maxima   ``core.loki.topk_lower_index``: a
                                   stable sort, ties to the lower index
                                   (``lax.top_k``'s order; ``torch.topk``
                                   promises none). The JAX package runs
                                   ``lax.top_k`` outside any Pallas kernel,
                                   so this stays a torch op.
  3. block_sparse_attention kernel exact attention over the selected blocks

``loki_decode_attention`` runs it over a token-major K̂ (BH, S, D),
``loki_decode_attention_fm`` over a feature-major K̂ᵀ (BH, D, S), whose
exact pass reads the selected blocks in place (no token-major copy of the
cache). ``flash`` is causal or non-causal flash attention.

Then the GQA-batched decode paths the engines call: the single-pass fused
Loki decode, the two-kernel pair, the streaming full decode and the fused
exact-top-k decode. Shapes follow ``fused_decode.fused_loki_decode``;
every one of those takes pooled caches with ``page_table``/``page_size``.
"""
from __future__ import annotations

from repro_torch.core.loki import topk_lower_index
from repro_torch.kernels.approx_scores import block_max_scores
from repro_torch.kernels.approx_scores_fm import block_max_scores_fm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_decode import (fused_exact_topk_decode,
                                              fused_loki_decode,
                                              select_blocks)
from repro_torch.kernels.gather_attention import (
    block_sparse_attention, block_sparse_attention_grouped,
    paged_full_decode)


def _select(blk_max, k_blocks: int):
    """The k_blocks best blocks of each row, ties to the lower index."""
    if not 1 <= k_blocks <= blk_max.shape[-1]:
        raise ValueError(f"k_blocks = {k_blocks} must lie in [1, "
                         f"{blk_max.shape[-1]}] (the number of blocks)")
    return topk_lower_index(blk_max, k_blocks)[1]


def loki_decode_attention(q_hat, k_hat, v, cur_len, *, d: int,
                          k_blocks: int, block_size: int = 128):
    """The per-head Loki decode step over flattened (BH) rows.

    q_hat (BH,D) PCA-basis post-RoPE query; k_hat (BH,S,D) PCA-basis cache;
    v (BH,S,D); cur_len (BH,). Returns (BH,D)."""
    scale = q_hat.shape[-1] ** -0.5
    blk_max = block_max_scores(q_hat, k_hat, cur_len, d=d,
                               block_size=block_size, scale=scale)
    return block_sparse_attention(q_hat, k_hat, v,
                                  _select(blk_max, k_blocks), cur_len,
                                  block_size=block_size, scale=scale)


def loki_decode_attention_fm(q_hat, k_hat_T, v, cur_len, *, d: int,
                             k_blocks: int, block_size: int = 128):
    """The per-head step over a feature-major K̂ᵀ (BH,D,S). The exact pass
    reads the selected blocks of K̂ᵀ through a transposed view, in
    place."""
    scale = q_hat.shape[-1] ** -0.5
    blk_max = block_max_scores_fm(q_hat, k_hat_T, cur_len, d=d,
                                  block_size=block_size, scale=scale)
    return block_sparse_attention(q_hat, k_hat_T.transpose(1, 2), v,
                                  _select(blk_max, k_blocks), cur_len,
                                  block_size=block_size, scale=scale)


def flash(q, k, v, *, causal: bool = True, block_q: int = 128,
          block_k: int = 128):
    """Flash attention: q (BH,Sq,D), k/v (BH,Sk,D) -> (BH,Sq,D)."""
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


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
