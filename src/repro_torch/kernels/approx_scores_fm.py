"""Per-head Loki block maxima over a feature-major cache: CUDA kernel and
plain version.

Counterpart of ``repro.kernels.approx_scores_fm.block_max_scores_fm`` (the
CUDA source is ``csrc/approx_scores.cu``, entry
``loki_block_max_scores_fm``): the output of ``approx_scores.
block_max_scores`` from K̂ᵀ stored (BH, D, S), bit for bit on the card.
On the TPU the layout made the d-slice sublane-aligned (DESIGN.md §3.1).
On Hopper a feature row is contiguous in tokens: each thread of a CTA
owns a 16-byte piece of its run (4 fp32 or 8 bf16 tokens) and reads it
from the leading d feature rows, two groups of 8 rows in flight, so each
row of a 1024-token fp32 run is one 4 KB stretch; pieces past cur_len
and runs with no live token are not read. Where ``block_size`` times the item size
is not a multiple of 16 the kernel scores single tokens instead. The TPU
kernel's contract stays: ``d % 8 == 0`` and ``S % block_size == 0``.

  q_hat    (BH, D)      query in the PCA basis
  k_hat_T  (BH, D, S)   key cache in the PCA basis, feature-major
  cur_len  (BH,)
Output:    (BH, S / block_size) float32, as the token-major kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
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


def fm_plan(q_hat, k_hat_T, *, d: int, block_size: int = 128) -> dict:
    """What block_max_scores_fm's launcher would use at these CUDA tensors'
    shapes, asked from the built library without a launch: ``vec`` (16-byte
    pieces, else single tokens), ``smem`` (dynamic shared memory, bytes;
    ``tuning.scores_fm_smem_bytes``), ``ctas_per_sm``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), ``registers`` and
    ``local_bytes`` (spills) a thread, ``blocks_per_cta``. For
    chip_smoke's log and checks."""
    bh, dim = q_hat.shape
    fn = _build.load("approx_scores").loki_block_max_scores_fm_info
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_longlong * 6)()
    _build.check(fn(_build.dtype_code(q_hat, "q_hat"),
                    _build.dtype_code(k_hat_T, "k_hat_T"), bh,
                    k_hat_T.shape[2], dim, d, block_size, info),
                 "block_max_scores_fm info")
    return dict(zip(("vec", "smem", "ctas_per_sm", "registers",
                     "local_bytes", "blocks_per_cta"), map(int, info)))
