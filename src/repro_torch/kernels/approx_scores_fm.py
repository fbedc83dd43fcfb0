"""Per-head Loki block maxima over a feature-major cache: CUDA kernel and
plain version.

Counterpart of ``repro.kernels.approx_scores_fm.block_max_scores_fm`` (the
CUDA source is ``csrc/approx_scores.cu``, entry
``loki_block_max_scores_fm``): the output of ``approx_scores.
block_max_scores`` from K̂ᵀ stored (BH, D, S). On the TPU the layout made
the d-slice sublane-aligned (DESIGN.md §3.1); on Hopper its kernel reads
neighbouring tokens of one feature row with neighbouring threads. The
TPU kernel's contract stays: ``d % 8 == 0`` and ``S % block_size == 0``.

  q_hat    (BH, D)      query in the PCA basis
  k_hat_T  (BH, D, S)   key cache in the PCA basis, feature-major
  cur_len  (BH,)
Output:    (BH, S / block_size) float32, as the token-major kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.approx_scores import (check_blocks, check_query,
                                               launch, mask_block_max)


def block_max_scores_fm_plain(q_hat, k_hat_T, cur_len, *, d, block_size,
                              scale):
    """Plain torch version: the token-major oracle's sum over K̂ᵀ."""
    s = torch.einsum("bd,bds->bs", q_hat[:, :d].float(),
                     k_hat_T[:, :d].float()) * scale
    return mask_block_max(s, cur_len, block_size)


def block_max_scores_fm(q_hat, k_hat_T, cur_len, *, d: int,
                        block_size: int = 128, scale=None):
    """(BH,D),(BH,D,S),(BH,) -> (BH, S/bs) float32 block maxima."""
    bh, dim = check_query(q_hat, k_hat_T.shape, d, cur_len)
    if k_hat_T.shape[1] != dim:
        raise ValueError(f"k_hat_T {tuple(k_hat_T.shape)} is not "
                         f"(BH, {dim}, S)")
    if d % 8:
        raise ValueError(f"feature-major slice d = {d} must be a multiple "
                         "of 8")
    s_len = k_hat_T.shape[2]
    check_blocks(s_len, block_size)
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return block_max_scores_fm_plain(q_hat, k_hat_T, cur_len, d=d,
                                         block_size=block_size, scale=scale)
    return launch("loki_block_max_scores_fm", block_max_scores_fm, q_hat,
                  k_hat_T, cur_len, s_len=s_len, d=d, block_size=block_size,
                  scale=scale)


block_max_scores_fm.launches = 0
