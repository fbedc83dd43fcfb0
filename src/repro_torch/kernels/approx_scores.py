"""Per-head Loki block maxima: CUDA kernel and plain version.

Counterpart of ``repro.kernels.approx_scores.block_max_scores`` (the CUDA
source is ``csrc/approx_scores.cu``, entry ``loki_block_max_scores``): for
each (batch x head) row and each cache block, the maximum over the block's
live tokens of ``q̂[:d]·K̂[s,:d] * scale`` — the statistic the per-head
pipeline's block top-k ranks on. Only the leading ``d`` features of the
cache are read.

  q_hat    (BH, D)      query in the PCA basis
  k_hat    (BH, S, D)   key cache in the PCA basis, token-major
  cur_len  (BH,)        live prefix length per row
Output:    (BH, S / block_size) float32; a position >= cur_len scores
           -1e30, so a block with no live position gives exactly -1e30.

The default scale is ``D**-0.5`` with D the full width, not d. The wrapper
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors; nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def check_blocks(s_len: int, block_size: int) -> int:
    """The number of blocks; raise where the JAX kernel asserts."""
    if block_size < 1 or s_len % block_size:
        raise ValueError(f"cache length {s_len} must be a multiple of "
                         f"block_size {block_size}")
    return s_len // block_size


def mask_block_max(s, cur_len, block_size: int):
    """(BH, S) float32 scores -> (BH, S/bs) block maxima, positions past
    cur_len at NEG_INF."""
    bh, s_len = s.shape
    pos = torch.arange(s_len, device=s.device)
    s = torch.where(pos[None] < cur_len.to(s.device).long()[:, None], s,
                    NEG_INF)
    return s.reshape(bh, s_len // block_size, block_size).amax(-1)


def block_max_scores_plain(q_hat, k_hat, cur_len, *, d, block_size, scale):
    """Plain torch version (``repro.kernels.ref.block_max_scores_ref``)."""
    s = torch.einsum("bd,bsd->bs", q_hat[:, :d].float(),
                     k_hat[..., :d].float()) * scale
    return mask_block_max(s, cur_len, block_size)


_FN: dict = {}


def launcher(name: str):
    """``loki_block_max_scores`` or its feature-major twin, typed."""
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(_build.load("approx_scores"), name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


def launch(name: str, counter, q_hat, k, cur_len, *, s_len, d, block_size,
           scale):
    """Launch one of the two block-maxima kernels; returns (BH, nb) f32."""
    bh, dim = q_hat.shape
    out = torch.empty((bh, s_len // block_size), dtype=torch.float32,
                      device=q_hat.device)
    ptrs = _build.cuda_args(counter.__name__, q_hat=q_hat, k_hat=k,
                            cur_len=cur_len.to(torch.int32), out=out)
    rc = launcher(name)(*ptrs, _build.dtype_code(q_hat, "q_hat"),
                        _build.dtype_code(k, "k_hat"), bh, s_len, dim, d,
                        block_size, scale, _build.stream_of(q_hat))
    _build.check(rc, counter.__name__)
    counter.launches += 1
    return out


def check_query(q_hat, k_shape, d: int, cur_len):
    bh, dim = q_hat.shape
    if k_shape[0] != bh or cur_len.shape != (bh,):
        raise ValueError(f"rows differ: q_hat {tuple(q_hat.shape)}, k "
                         f"{tuple(k_shape)}, cur_len {tuple(cur_len.shape)}")
    if not 1 <= d <= dim:
        raise ValueError(f"d = {d} must lie in [1, {dim}]")
    return bh, dim


def block_max_scores(q_hat, k_hat, cur_len, *, d: int, block_size: int = 128,
                     scale=None):
    """(BH,D),(BH,S,D),(BH,) -> (BH, S/bs) float32 block maxima of the
    approximate scores."""
    bh, dim = check_query(q_hat, k_hat.shape, d, cur_len)
    if k_hat.shape[2] != dim:
        raise ValueError(f"k_hat {tuple(k_hat.shape)} is not (BH, S, {dim})")
    s_len = k_hat.shape[1]
    check_blocks(s_len, block_size)
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q_hat.is_cuda:
        return block_max_scores_plain(q_hat, k_hat, cur_len, d=d,
                                      block_size=block_size, scale=scale)
    return launch("loki_block_max_scores", block_max_scores, q_hat, k_hat,
                  cur_len, s_len=s_len, d=d, block_size=block_size,
                  scale=scale)


block_max_scores.launches = 0
