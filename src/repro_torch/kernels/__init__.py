"""Hand-written CUDA decode kernels of the port, each beside its plain
torch version. Every wrapper carries a plain integer ``launches`` that it
bumps where it launches its kernel, and nowhere else."""
from repro_torch.kernels.fused_decode import (fused_exact_topk_decode,
                                              fused_loki_decode,
                                              select_blocks)
from repro_torch.kernels.gather_attention import (
    block_sparse_attention_grouped, paged_full_decode)

KERNELS = (fused_loki_decode, select_blocks, block_sparse_attention_grouped,
           paged_full_decode, fused_exact_topk_decode)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
