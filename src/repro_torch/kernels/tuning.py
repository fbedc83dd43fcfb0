"""Plan selection for the CUDA decode kernels.

``plan_decode`` maps a decode shape ``(S, D, G, d, bs_hint)`` to a kernel
plan: which variant runs (single-pass ``fused`` or the ``two_kernel`` pair
select_blocks + block_sparse_attention_grouped) and at what block size.
``plan_full_decode`` picks the block size of the split-KV full-decode
kernel. ``None`` means no kernel takes the shape; the dispatcher then falls
back to the plain torch path on CPU tensors and raises on CUDA tensors. A
paged call whose page size the plan's block does not divide gets no plan
either (the dispatcher checks; a block must not straddle two pages).

The budget is the kernels' real dynamic shared memory against the H100's
per-block opt-in limit: every kernel's rings copy cache rows as they are
stored, so each budget depends on the cache's storage type, named as
torch names the dtype (``storage_of``). The attention rings take one of two
layouts: the wide body's (float32, bfloat16: 4-token stages) or the narrow
body's (float16, int8, float8_e4m3fn: stages sized in bytes,
``narrow_tokens``), so float16 and bfloat16 take different layouts
although both are 2 bytes. One-byte storage (int8, fp8) is always scaled: each
narrow stage also holds its page's K and V scales (float32). ``TUNED``
pins measured shapes; it stays empty until shapes have been measured on
the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: H100 per-block shared memory with the opt-in attribute (232,448 B)
SMEM_LIMIT = 227 * 1024
#: kernel limits: query heads per KV group, key/value width
MAX_G = 16
MAX_DIM = 256

# (S, D, G, block_size hint) -> (variant, block_size), measured on the card
TUNED: dict = {}

_BS_CANDIDATES = (128, 64, 32, 16, 8)


#: the split-KV bodies of the full decode and the fused kernels
#: (csrc/decode_common.cuh): warps per CTA, tokens per wide ring stage,
#: ring stages per warp
SPLIT_WARPS, SPLIT_TOK, SPLIT_STAGES = 4, 4, 2
#: the narrow body's stages: K and V row bytes at most, tokens at most
NARROW_STAGE_BYTES, NARROW_MAX_TOK = 5120, 32
#: the score stream of the fused kernels, select_blocks and
#: block_max_scores (csrc/decode_common.cuh score_range): ring stages per
#: warp, tokens per chunk at most (one a lane), bytes per stage at most
SCORE_STAGES, SCORE_MAX_TOK, SCORE_STAGE_BYTES = 2, 32, 32 * 144

#: bytes per element of each storage type the decode kernels take
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
            "float8_e4m3fn": 1}
#: the storage types of the narrow attention body, and the scaled ones
NARROW = ("float16", "int8", "float8_e4m3fn")
SCALED = ("int8", "float8_e4m3fn")


def storage_of(t) -> str:
    """A cache tensor's storage type as these functions name it."""
    return str(t.dtype).removeprefix("torch.")


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def narrow_tokens(*, kdim: int, dim: int, storage: str) -> int:
    """Tokens per narrow ring stage (``narrow_tokens`` in
    csrc/decode_common.cuh): the largest power of two up to 32 whose K̂ and
    V rows, as stored, fit NARROW_STAGE_BYTES. A launch streams chunks of
    this many tokens cut to the largest power of two dividing the block
    size, so a chunk never leaves its block."""
    tok, row = NARROW_MAX_TOK, (kdim + dim) * ITEMSIZE[storage]
    while tok > 1 and tok * row > NARROW_STAGE_BYTES:
        tok //= 2
    return tok


def split_stage_bytes(*, kdim: int, dim: int, storage: str,
                      tok: int = 0) -> int:
    """One warp's attention ring stage (``attn_stage_bytes`` in
    csrc/decode_common.cuh) of ``tok`` tokens (0: the body's own). The
    wide body (float32, bfloat16): ``tok`` (SPLIT_TOK) K̂ and V rows in the
    storage dtype, rows padded to 4 elements. The narrow body (float16,
    int8, fp8): ``tok`` (``narrow_tokens``) K̂ rows of an odd number of
    16-byte pieces (against bank conflicts), as many V rows, then 16 bytes
    for the page's K and V scales when scaled."""
    isz = ITEMSIZE[storage]
    if storage not in NARROW:
        return _round16((tok or SPLIT_TOK) * (_pad4(kdim) + _pad4(dim))
                        * isz)
    tok = tok or narrow_tokens(kdim=kdim, dim=dim, storage=storage)
    k_pitch = ((kdim * isz + 15) // 16 | 1) * 16
    return (tok * (k_pitch + _round16(dim * isz))
            + (16 if storage in SCALED else 0))


def score_tokens(*, d: int, bs: int, itemsize: int) -> tuple:
    """(tokens per score chunk, bytes per staged token row) of the fused
    kernels: a row is the leading d features rounded up to 16 bytes plus
    16 bytes against bank conflicts; the chunk is the largest power of two
    up to 32 that divides bs and keeps a stage within SCORE_STAGE_BYTES."""
    row = _round16(d * itemsize) + 16
    tok = SCORE_MAX_TOK
    while tok > 1 and (tok * row > SCORE_STAGE_BYTES or bs % tok):
        tok //= 2
    return tok, row



#: block_max_scores_fm's run: 256 threads x one 16-byte piece of tokens
#: each (csrc/approx_scores.cu FM_RUN_BYTES)
FM_RUN_BYTES = 256 * 16


def scores_fm_smem_bytes(*, bs: int, storage: str) -> int:
    """block_max_scores_fm (the feature-major per-head block maxima): one
    float32 score a token of the CTA's run, the whole blocks within
    FM_RUN_BYTES of tokens (1024 float32, 2048 bfloat16; one block where
    bs is longer). It does not depend on d: the query is read from device
    memory. The launcher computes the same (``FmPlan``, reported by
    ``loki_block_max_scores_fm_info``)."""
    run = FM_RUN_BYTES // ITEMSIZE[storage]
    return 4 * max(1, run // bs) * bs

def fused_smem_bytes(*, nb: int, k_blocks: int, g: int, kdim: int,
                     dim: int, bs: int, d: int, storage: str) -> int:
    """The fused cluster kernels (fused_loki_decode; fused_exact_topk_decode
    at d = kdim): the scaled float32 query, the (nb,) block-maxima row, the
    selection (k_blocks ints), the argmax exchange (2 x 4 warps), and one
    region that holds in turn the 4 warps' score rings, the selection's
    copy of the row, the 4 warps' attention rings and the warp merge plus
    the CTA's partial. The launcher computes the same
    (``loki_fused_smem_bytes``, csrc/fused_decode.cu)."""
    tok, row = score_tokens(d=d, bs=bs, itemsize=ITEMSIZE[storage])
    fixed = (_round16(4 * g * _pad4(kdim)) + _round16(4 * nb)
             + _round16(4 * k_blocks) + _round16(2 * SPLIT_WARPS * 8))
    score_ring = SPLIT_WARPS * SCORE_STAGES * tok * row
    attn_ring = SPLIT_WARPS * SPLIT_STAGES * split_stage_bytes(
        kdim=kdim, dim=dim, storage=storage)
    merge = 4 * (SPLIT_WARPS + 1) * g * (dim + 2)
    return fixed + _round16(max(score_ring, attn_ring, merge, 4 * nb))


def select_smem_bytes(*, nb: int, g: int, kdim: int, d: int, bs: int,
                      storage: str) -> int:
    """select_blocks' cluster kernel: the scaled float32 query, the (nb,)
    block-maxima row (it selects in place, no copy of the row), the argmax
    exchange (2 x 4 warps), then the 4 warps' score rings of
    ``score_tokens`` rows, the chunk halved while the whole exceeds
    SMEM_LIMIT (the block maxima do not depend on it). The launcher
    computes the same (``loki_select_smem_bytes``, csrc/decode_common.cuh
    score_layout)."""
    tok, row = score_tokens(d=d, bs=bs, itemsize=ITEMSIZE[storage])
    fixed = (_round16(4 * g * _pad4(kdim)) + _round16(4 * nb)
             + _round16(2 * SPLIT_WARPS * 8))
    while tok > 1 and fixed + SPLIT_WARPS * SCORE_STAGES * tok * row \
            > SMEM_LIMIT:
        tok //= 2
    return fixed + SPLIT_WARPS * SCORE_STAGES * tok * row


def attend_smem_bytes(*, n_sel: int, g: int, kdim: int, dim: int,
                      storage: str, tok: int = SPLIT_TOK) -> int:
    """block_sparse_attention_grouped (``tok`` = 4) and, at g = 1 and kdim
    = dim, block_sparse_attention (``tok`` = 16 // itemsize): the float32
    query (G, W) and the kept block list (n_sel ints), then the 4 warps'
    rings of SPLIT_STAGES stages, which the warp merge and the CTA's
    partial ((SPLIT_WARPS + 1) G (D + 2) float32) reuse. The wide body's
    stages hold ``tok`` tokens; the narrow body's ``narrow_tokens``,
    halved while the whole exceeds SMEM_LIMIT (a list of tens of thousands
    of blocks). The launchers compute the same (``loki_attend_smem_bytes``,
    csrc/gather_attention.cu)."""
    merge = 4 * (SPLIT_WARPS + 1) * g * (dim + 2)
    fixed = _round16(4 * g * _pad4(kdim)) + _round16(4 * n_sel)

    def total(t):
        return fixed + _round16(max(SPLIT_WARPS * SPLIT_STAGES
                                    * split_stage_bytes(kdim=kdim, dim=dim,
                                                        storage=storage,
                                                        tok=t), merge))
    if storage not in NARROW:
        return total(tok)
    tok = narrow_tokens(kdim=kdim, dim=dim, storage=storage)
    while tok > 1 and total(tok) > SMEM_LIMIT:
        tok //= 2
    return total(tok)


def full_smem_bytes(*, g: int, kdim: int, dim: int, storage: str) -> int:
    """paged_full_decode (split-KV): the scaled float32 query (G, W) and
    each warp's ring of SPLIT_STAGES stages (``split_stage_bytes``); the
    warps' log-sum-exp merge, (G, D + 2) float32 each, reuses the ring. It
    does not grow with smax or the block size. The launcher computes the
    same (``split_smem_bytes``, exported as ``loki_full_smem_bytes``,
    csrc/gather_attention.cu)."""
    ring = SPLIT_WARPS * SPLIT_STAGES * split_stage_bytes(
        kdim=kdim, dim=dim, storage=storage)
    merge = 4 * SPLIT_WARPS * g * (dim + 2)
    return _round16(4 * g * _pad4(kdim)) + max(ring, merge)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    variant: str          # "fused" | "two_kernel" | "stream"
    block_size: int


def _block_size(smax: int, block_size: int) -> int:
    """The config's block size if it divides smax, else the largest
    candidate that does, else 0."""
    for cand in dict.fromkeys((block_size,) + _BS_CANDIDATES):
        if cand > 0 and smax % cand == 0 and smax >= cand:
            return cand
    return 0


def plan_full_decode(smax: int, dim: int, g: int, kdim: int,
                     block_size: int,
                     storage: str = "float32") -> Optional[KernelPlan]:
    """Block size of the split-KV full-decode kernel, or None for no
    kernel. The block size is the unit its splits share out; its shared
    memory (``full_smem_bytes``) depends on G, the widths and the storage
    only, and every shape it takes (G <= 16, W <= D <= 256, any storage)
    fits SMEM_LIMIT: the budget check cannot refuse one."""
    if g > MAX_G or dim > MAX_DIM or kdim > dim:
        return None
    bs = _block_size(smax, block_size)
    if not bs or full_smem_bytes(g=g, kdim=kdim, dim=dim,
                                 storage=storage) > SMEM_LIMIT:
        return None
    return KernelPlan("stream", bs)


def plan_decode(smax: int, dim: int, g: int, d: int, block_size: int,
                storage: str = "float32") -> Optional[KernelPlan]:
    """Pick (variant, block_size) for one decode step, or None for no
    kernel. ``d`` is the score width (the approximate width, or the stored
    key width for exact top-k), ``block_size`` the config hint,
    ``storage`` the cache's storage type (the kernels' rings hold cache
    rows as stored). The budget assumes the widest case, kdim = dim and
    k_blocks = nb."""
    if g > MAX_G or dim > MAX_DIM or d > dim:
        return None
    key = (smax, dim, g, block_size)
    if key in TUNED:
        variant, bs = TUNED[key]
        if smax % bs == 0:
            return KernelPlan(variant, bs)

    bs = _block_size(smax, block_size)
    if not bs:
        return None
    nb = smax // bs
    if fused_smem_bytes(nb=nb, k_blocks=nb, g=g, kdim=dim, dim=dim, bs=bs,
                        d=d, storage=storage) <= SMEM_LIMIT:
        return KernelPlan("fused", bs)
    if (select_smem_bytes(nb=nb, g=g, kdim=dim, d=d, bs=bs,
                          storage=storage) <= SMEM_LIMIT
            and attend_smem_bytes(n_sel=nb, g=g, kdim=dim, dim=dim,
                                  storage=storage) <= SMEM_LIMIT):
        return KernelPlan("two_kernel", bs)
    return None
