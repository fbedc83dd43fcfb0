"""Plan selection for the CUDA Loki decode kernels.

``plan_decode`` maps a decode shape ``(S, D, G, d, bs_hint)`` to a kernel
plan: which variant runs (single-pass ``fused`` or the ``two_kernel`` pair
select_blocks + block_sparse_attention_grouped) and at what block size.
``None`` means no kernel takes the shape; the dispatcher then falls back to
the plain torch path on CPU tensors and raises on CUDA tensors.

The budget is the kernels' real dynamic shared memory (csrc/*.cu: every
staged value is float32, so the cache dtype does not enter) against the
H100's per-block opt-in limit. ``TUNED`` pins measured shapes; it stays
empty until shapes have been measured on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: H100 per-block shared memory with the opt-in attribute (232,448 B)
SMEM_LIMIT = 227 * 1024
#: threads per CUDA block of every decode kernel (csrc/decode_common.cuh)
THREADS = 256
#: kernel limits: query heads per KV group, key/value width
MAX_G = 16
MAX_DIM = 256

# (S, D, G, block_size hint) -> (variant, block_size), measured on the card
TUNED: dict = {}

_BS_CANDIDATES = (128, 64, 32, 16, 8)


def select_smem_bytes(*, nb: int, g: int, kdim: int) -> int:
    """select_blocks: the scaled query (G, W) and the block-maxima row."""
    return 4 * (g * kdim + nb)


def attend_smem_bytes(*, n_sel: int, g: int, kdim: int, dim: int,
                      bs: int) -> int:
    """block_sparse_attention_grouped: query, selection, one block's
    (G, bs) scores, the (G,) softmax state and the split-reduction
    buffer for the (G, D) accumulators."""
    nsplit = THREADS // dim
    return 4 * (g * kdim + n_sel + g * bs + 3 * g + nsplit * g * dim)


def fused_smem_bytes(*, nb: int, k_blocks: int, g: int, kdim: int,
                     dim: int, bs: int) -> int:
    """fused_loki_decode: the block-maxima row plus everything the
    attention phase holds."""
    return 4 * nb + attend_smem_bytes(n_sel=k_blocks, g=g, kdim=kdim,
                                      dim=dim, bs=bs)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    variant: str          # "fused" | "two_kernel"
    block_size: int


def plan_decode(smax: int, dim: int, g: int, d: int, block_size: int,
                itemsize: int = 4) -> Optional[KernelPlan]:
    """Pick (variant, block_size) for one decode step, or None for no
    kernel. ``d`` is the approximate-score width, ``block_size`` the
    config hint. ``itemsize`` (the cache dtype width) is kept for the JAX
    package's interface; the kernels stage float32 whatever the cache
    holds, so it does not change the budget. The budget assumes the
    widest case, kdim = dim and k_blocks = nb."""
    del itemsize
    if g > MAX_G or dim > MAX_DIM or d > dim:
        return None
    key = (smax, dim, g, block_size)
    if key in TUNED:
        variant, bs = TUNED[key]
        if smax % bs == 0:
            return KernelPlan(variant, bs)

    bs = 0
    for cand in dict.fromkeys((block_size,) + _BS_CANDIDATES):
        if cand > 0 and smax % cand == 0 and smax >= cand:
            bs = cand
            break
    if not bs:
        return None
    nb = smax // bs
    if fused_smem_bytes(nb=nb, k_blocks=nb, g=g, kdim=dim, dim=dim,
                        bs=bs) <= SMEM_LIMIT:
        return KernelPlan("fused", bs)
    if (select_smem_bytes(nb=nb, g=g, kdim=dim) <= SMEM_LIMIT
            and attend_smem_bytes(n_sel=nb, g=g, kdim=dim, dim=dim,
                                  bs=bs) <= SMEM_LIMIT):
        return KernelPlan("two_kernel", bs)
    return None
