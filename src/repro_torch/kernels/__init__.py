"""Hand-written CUDA kernels of the port, each beside its plain torch
version. Every wrapper carries a plain integer ``launches`` that it bumps
where it launches its kernel, and nowhere else. (``kernels.flash_attention``
stays the module; its wrapper is ``kernels.flash_attention.flash_attention``.)
"""
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.approx_scores import block_max_scores
from repro_torch.kernels.approx_scores_fm import block_max_scores_fm
from repro_torch.kernels.fused_decode import (fused_exact_topk_decode,
                                              fused_loki_decode,
                                              select_blocks)
from repro_torch.kernels.gather_attention import (
    block_sparse_attention, block_sparse_attention_grouped,
    paged_full_decode)

KERNELS = (fused_loki_decode, select_blocks, block_sparse_attention_grouped,
           paged_full_decode, fused_exact_topk_decode, _flash.flash_attention,
           block_max_scores, block_sparse_attention, block_max_scores_fm)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
