"""Flash attention (prefill / train shapes): CUDA kernel and plain version.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the CUDA
source is ``csrc/flash_attention.cu``, entry ``loki_flash_attention``).

  q     (BH, Sq, D)
  k, v  (BH, Sk, D)
Output: (BH, Sq, D) in q's dtype. The causal mask is top-left aligned:
query i sees keys j <= i, both counted from 0, also when Sq != Sk.

The plain version computes in float32. On the card, bf16 q, k and v run
the tensor-core body: bf16 products summed in float32, a float32 online
softmax, and P rounded to bf16 before P·V (the one rounding the float32
version does not have); D must then be a multiple of 8 (TMA's 16-byte row
strides). Every other dtype combination runs the float32 body, q scaled
in float32 before the dot.

The JAX contract holds at this function: ``bq, bk = min(block_q, Sq),
min(block_k, Sk)`` must divide Sq and Sk, else ValueError. ``block_q`` and
``block_k`` are the contract's; the CUDA kernel tiles by its own sizes and
masks any ragged edge itself. The wrapper launches the kernel for CUDA
tensors and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal, scale):
    """Plain torch version (``repro.kernels.ref.flash_attention_ref``)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


_FN: dict = {}


def _lib():
    fn = _FN.get("fn")
    if fn is None:
        fn = _build.load("flash_attention").loki_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN["fn"] = fn
    return fn


def flash_attention(q, k, v, *, block_q: int = 128, block_k: int = 128,
                    causal: bool = True, scale=None):
    """q (BH, Sq, D); k, v (BH, Sk, D) -> (BH, Sq, D). Default scale
    ``D**-0.5``."""
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    bh, sq, dim = q.shape
    sk = k.shape[1]
    bq, bk = min(block_q, sq), min(block_k, sk)
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"Sq = {sq} and Sk = {sk} must be multiples of "
                         f"their blocks {bq} and {bk}")
    scale = float(scale if scale is not None else dim ** -0.5)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if k.dtype != v.dtype:
        raise TypeError("k and v must share a dtype")
    if q.dtype == k.dtype == torch.bfloat16 and dim % 8:
        raise ValueError(f"bf16 flash_attention needs D a multiple of 8, "
                         f"got {dim}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = _build.cuda_args("flash_attention", q=q, k=k, v=v, out=out)
    rc = _lib()(*ptrs, _build.dtype_code(q, "q"), _build.dtype_code(k, "k"),
                bh, sq, sk, dim, int(bool(causal)), scale,
                _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
