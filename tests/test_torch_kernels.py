"""The port's decode kernels against the JAX package's Pallas kernels.

On CPU tensors the port's wrappers run the kernels' plain torch versions
(the CUDA kernels are held against those same plain versions on the card by
chip_smoke.py). Here the plain versions meet the JAX kernels in interpret
mode on the same numpy inputs, contiguous and paged: block indices must be
equal, outputs within rtol = atol = 2e-5 — the tolerance
tests/test_fused_decode.py uses for two float32 implementations that sum
in different orders.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LokiConfig as JLokiConfig
from repro.core import baselines as jbaselines
from repro.core import dispatch as jdispatch
from repro.core import loki as jloki
from repro.kernels import fused_decode as jfused
from repro.kernels import gather_attention as jgather
from repro.kernels import ops as jops
from repro_torch.configs.base import LokiConfig
from repro_torch.core import baselines, dispatch, loki
from repro_torch.kernels import fused_decode, gather_attention, ops, tuning

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, hkv, g, s, w, dim, seed, cur):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv, g, w).astype(np.float32)
    k = rng.randn(b, s, hkv, w).astype(np.float32)
    v = rng.randn(b, s, hkv, dim).astype(np.float32)
    return q, k, v, np.asarray(cur, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


WINDOWS = [(0, 0), (16, 0), (0, 48), (8, 48)]      # (local, sliding)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("lw,sw", WINDOWS)
@pytest.mark.parametrize("w", [32, 16])
def test_select_and_fused_match_jax(g, lw, sw, w):
    """select_blocks and fused_loki_decode, W = D and W < D (scale pinned),
    recency and sliding windows on and off, one short row forcing -1."""
    dim, bs, s = 32, 16, 128
    q, k, v, cur = _inputs(2, 2, g, s, w, dim, seed=g * 10 + w + lw + sw,
                           cur=[113, 21])
    kw = dict(d=8, k_blocks=4, block_size=bs, local_window=lw,
              sliding_window=sw, scale=dim ** -0.5)
    want_idx = np.asarray(jfused.select_blocks(*_j(q, k, cur), **kw,
                                               interpret=True))
    got_idx = fused_decode.select_blocks(*_t(q, k, cur), **kw).numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    if not sw:
        assert (want_idx[1] == -1).any()           # short row: sentinels
    want = np.asarray(jfused.fused_loki_decode(*_j(q, k, v, cur), **kw,
                                               interpret=True))
    got = fused_decode.fused_loki_decode(*_t(q, k, v, cur), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_default_scales_differ_as_in_jax():
    """select_blocks defaults to W**-0.5, fused_loki_decode to D**-0.5."""
    q, k, v, cur = _inputs(1, 2, 2, 64, 16, 32, seed=3, cur=[64])
    kw = dict(d=8, k_blocks=2, block_size=16)
    np.testing.assert_array_equal(
        fused_decode.select_blocks(*_t(q, k, cur), **kw).numpy(),
        np.asarray(jfused.select_blocks(*_j(q, k, cur), **kw,
                                        interpret=True)))
    np.testing.assert_allclose(
        fused_decode.fused_loki_decode(*_t(q, k, v, cur), **kw).numpy(),
        np.asarray(jfused.fused_loki_decode(*_j(q, k, v, cur), **kw,
                                            interpret=True)), **TOL)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sw", [0, 40])
@pytest.mark.parametrize("w", [32, 16])
def test_grouped_attention_matches_jax(g, sw, w):
    """block_sparse_attention_grouped over a selection holding -1."""
    dim, bs, s = 32, 32, 256
    q, k, v, cur = _inputs(2, 2, g, s, w, dim, seed=7 + g + w, cur=[250, 70])
    blk = np.array([[[7, 2, 0, -1], [3, -1, 5, 1]],
                    [[2, 0, 1, -1], [0, 1, -1, -1]]], np.int32)
    kw = dict(block_size=bs, sliding_window=sw,
              scale=None if w == dim else dim ** -0.5)
    want = np.asarray(jgather.block_sparse_attention_grouped(
        *_j(q, k, v, blk, cur), **kw, interpret=True))
    got = gather_attention.block_sparse_attention_grouped(
        *_t(q, k, v, blk, cur), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("g", [1, 4])
def test_two_kernel_matches_jax_and_fused(g):
    dim, bs = 32, 32
    q, k, v, cur = _inputs(2, 2, g, 256, dim, dim, seed=11, cur=[256, 90])
    kw = dict(d=8, k_blocks=3, block_size=bs, local_window=16,
              sliding_window=0)
    want = np.asarray(jops.loki_decode_two_kernel(*_j(q, k, v, cur), **kw,
                                                  interpret=True))
    got = ops.loki_decode_two_kernel(*_t(q, k, v, cur), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    fused = ops.loki_decode_fused(*_t(q, k, v, cur), **kw).numpy()
    np.testing.assert_allclose(fused, got, **TOL)


def test_tie_between_block_maxima_goes_to_lower_index():
    """Blocks 1, 3 and 6 hold identical keys, so their maxima tie exactly:
    argmax-and-suppress takes them in index order, as lax.top_k does."""
    q, k, v, cur = _inputs(1, 1, 2, 128, 32, 32, seed=5, cur=[128])
    bs = 16
    # one key aligned with head 0's query makes block 1 the clear winner
    k[0, bs:2 * bs] = 0.0
    k[0, bs, 0] = 10 * q[0, 0, 0] / np.linalg.norm(q[0, 0, 0])
    for blk in (3, 6):
        k[0, blk * bs:(blk + 1) * bs] = k[0, 1 * bs:2 * bs]
    kw = dict(d=32, k_blocks=4, block_size=bs, local_window=0)
    got = fused_decode.select_blocks(*_t(q, k, cur), **kw).numpy()
    want = np.asarray(jfused.select_blocks(*_j(q, k, cur), **kw,
                                           interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, :3].tolist() == [1, 3, 6]


def _orthogonal(hkv, dim, seed):
    rng = np.random.RandomState(seed)
    return np.stack([np.linalg.qr(rng.randn(dim, dim))[0]
                     for _ in range(hkv)]).astype(np.float32)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("group_select", [False, True])
def test_loki_decode_block_matches_jax(g, group_select):
    """The plain block reference, per-head and group-shared, and (for the
    group-shared one) the fused kernel's plain version beside it."""
    b, hkv, s, dim, bs = 2, 2, 128, 32, 16
    rng = np.random.RandomState(g)
    q = rng.randn(b, hkv * g, dim).astype(np.float32)
    k = rng.randn(b, s, hkv, dim).astype(np.float32)
    v = rng.randn(b, s, hkv, dim).astype(np.float32)
    proj = _orthogonal(hkv, dim, seed=g)
    cur = np.array([s, 45], np.int32)
    jcfg = JLokiConfig(enabled=True, d_f=0.25, k_f=0.25, block_size=bs,
                       local_window=16)
    cfg = LokiConfig(**dataclasses.asdict(jcfg))
    want = np.asarray(jloki.loki_decode_block(
        *_j(q, k, v, cur, proj), jcfg, group_select=group_select))
    got = loki.loki_decode_block(*_t(q, k, v, cur, proj), cfg,
                                 group_select=group_select).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if group_select:
        q_hat = np.einsum("bhgd,hde->bhge", q.reshape(b, hkv, g, dim), proj)
        fused = fused_decode.fused_loki_decode(
            *_t(q_hat.astype(np.float32), k, v, cur), d=8, k_blocks=2,
            block_size=bs, local_window=16).numpy()
        np.testing.assert_allclose(fused.reshape(b, hkv * g, dim), want,
                                   **TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("kd", [32, 16])
def test_dispatch_matches_jax(backend, kd):
    """loki_block_decode through each backend, full and truncated keys."""
    b, hkv, g, s, dim = 2, 2, 2, 128, 32
    rng = np.random.RandomState(kd)
    q = rng.randn(b, hkv * g, dim).astype(np.float32)
    k = rng.randn(b, s, hkv, kd).astype(np.float32)
    v = rng.randn(b, s, hkv, dim).astype(np.float32)
    proj = _orthogonal(hkv, dim, seed=1)
    cur = np.array([100, 17], np.int32)
    jcfg = JLokiConfig(enabled=True, block_size=32, backend=backend)
    cfg = LokiConfig(**dataclasses.asdict(jcfg))
    want = np.asarray(jdispatch.loki_block_decode(*_j(q, k, v, cur, proj),
                                                  jcfg, interpret=True))
    got = dispatch.loki_block_decode(*_t(q, k, v, cur, proj), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_resolve_backend_and_disable_ladder():
    assert dispatch.resolve_backend("auto", "cpu") == "xla"
    assert dispatch.resolve_backend("auto", "cuda") == "pallas"
    assert dispatch.resolve_backend("pallas", "cpu") == "pallas"
    with pytest.raises(ValueError):
        dispatch.resolve_backend("tpu")
    with pytest.raises(ValueError):
        dispatch.disable_backend("auto")
    dispatch.disable_backend("pallas", "test")
    try:
        assert dispatch.backend_disabled("pallas") == "test"
        # the CPU steps down to the plain path; CUDA has no fallback
        assert dispatch.resolve_backend("pallas", "cpu") == "xla"
        for backend in ("pallas", "auto"):
            with pytest.raises(RuntimeError, match="disabled"):
                dispatch.resolve_backend(backend, "cuda")
    finally:
        dispatch.enable_backend("pallas")
    assert dispatch.backend_disabled("pallas") is None


@pytest.mark.parametrize("g,smax", [(32, 128), (1, 100)])
def test_cuda_decode_without_plan_raises(g, smax, monkeypatch):
    """A shape no kernel plan takes (G > 16; smax no block size divides)
    falls back to torch on CPU tensors but raises for CUDA tensors. The
    tensors here pose as CUDA ones: the raise comes before any device op
    (chip_smoke.py checks it with real CUDA tensors)."""
    rng = np.random.RandomState(0)
    q = rng.randn(1, g, 16).astype(np.float32)
    k = rng.randn(1, smax, 1, 16).astype(np.float32)
    proj = np.eye(16, dtype=np.float32)[None]
    args = _t(q, k, k, np.array([50], np.int32), proj)
    cfg = LokiConfig(enabled=True, block_size=16, backend="pallas")
    assert dispatch.loki_block_decode(*args, cfg).shape == (1, g, 16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(NotImplementedError, match="no CUDA kernel plan"):
        dispatch.loki_block_decode(*args, cfg)


def test_plan_decode_budget():
    # the main path: llama2-7b, smax 4096, G = 1
    assert tuning.plan_decode(4096, 128, 1, 32, 128) == \
        tuning.KernelPlan("fused", 128)
    # the fused cluster kernel's shared memory (csrc/fused_decode.cu,
    # fused_layout) at the main path's shape: query 512 B, block-maxima row
    # 128 B, selection 32 B, argmax exchange 64 B, then the largest of the
    # 4 warps' score rings (2 stages of 32 tokens of 144 B), attention
    # rings (2 stages of 4 x 256 fp32) and merge buffers
    main = dict(nb=32, k_blocks=8, g=1, kdim=128, dim=128, bs=128)
    assert tuning.fused_smem_bytes(**main, d=32, storage="float32") == \
        512 + 128 + 32 + 64 + 4 * 2 * 32 * 144
    # exact top-k scores all 128 features: 8 tokens of 528 B a stage
    assert tuning.fused_smem_bytes(**main, d=128, storage="float32") == \
        736 + 4 * 2 * 8 * 528
    # a bf16 cache: 32 tokens of 80 B a score stage, still the largest
    assert tuning.fused_smem_bytes(**main, d=32, storage="bfloat16") == \
        736 + 4 * 2 * 32 * 80
    # narrow storage: the attention ring is the largest use of the region,
    # 2 stages of 8 fp16 tokens (K rows of 17 16-byte pieces, V rows of
    # 256 B) or 16 int8 tokens (9-piece K rows, 128 B V rows, 16 B of
    # scales), where a bf16 cache's 4 tokens of 512 B stay below the score
    # ring
    assert tuning.fused_smem_bytes(**main, d=32, storage="float16") == \
        736 + 4 * 2 * 8 * (272 + 256)
    assert tuning.fused_smem_bytes(**main, d=32, storage="int8") == \
        736 + 4 * 2 * (16 * (144 + 128) + 16)
    assert tuning.narrow_tokens(kdim=128, dim=128, storage="float16") == 8
    assert tuning.narrow_tokens(kdim=32, dim=128, storage="int8") == 32
    assert tuning.score_tokens(d=32, bs=8, itemsize=4) == (8, 144)
    assert tuning.score_tokens(d=32, bs=128, itemsize=4) == (32, 144)
    # select_blocks' cluster kernel (csrc/decode_common.cuh, score_layout)
    # at the main path's shape: query 512 B, block-maxima row 128 B, argmax
    # exchange 64 B, then the 4 warps' score rings (2 stages of 32 tokens
    # of 144 B); it selects in place, so no copy of the row
    assert tuning.select_smem_bytes(nb=32, g=1, kdim=128, d=32, bs=128,
                                    storage="float32") == \
        512 + 128 + 64 + 4 * 2 * 32 * 144
    # int8 codes at rank 32: 32 tokens of 48 B a stage
    assert tuning.select_smem_bytes(nb=32, g=1, kdim=32, d=32, bs=128,
                                    storage="int8") == \
        128 + 128 + 64 + 4 * 2 * 32 * 48
    # a score row too long for the fused kernel's shared memory
    big = tuning.plan_decode(2 ** 22, 256, 16, 64, 128)
    assert big == tuning.KernelPlan("two_kernel", 128)
    assert tuning.plan_decode(4096, 128, 32, 32, 128) is None      # G > 16
    assert tuning.plan_decode(4096, 512, 1, 32, 128) is None       # D > 256
    assert tuning.plan_decode(100, 128, 1, 32, 128) is None        # no bs
    assert tuning.plan_decode(96, 64, 2, 16, 128).block_size == 32


def test_scores_fm_smem_bytes():
    """block_max_scores_fm's shared memory (csrc/approx_scores.cu FmPlan):
    a float32 score a token of the run, 1024 float32 or 2048 bfloat16
    tokens at the per-head main shape (8 or 16 blocks of 128), the whole
    blocks within the run at bs 30, one block where it is longer."""
    assert tuning.scores_fm_smem_bytes(bs=128, storage="float32") == \
        4 * 1024
    assert tuning.scores_fm_smem_bytes(bs=128, storage="bfloat16") == \
        4 * 2048
    assert tuning.scores_fm_smem_bytes(bs=30, storage="float32") == \
        4 * 34 * 30
    assert tuning.scores_fm_smem_bytes(bs=4096, storage="float32") == \
        4 * 4096


# (smax, dim, G, d, storage) -> the plan before select_blocks became a
# cluster kernel and the narrow storages their own attention body, which
# it must keep
ROUTES = {
    "main": ((4096, 128, 1, 32, "float32"), ("fused", 128)),
    "two_kernel": ((2 ** 22, 256, 16, 64, "float32"), ("two_kernel", 128)),
    # select_blocks fits only with 16-token score chunks
    "halved_chunk": ((49152 * 128, 128, 1, 32, "float32"),
                     ("two_kernel", 128)),
    "none": ((2 ** 24, 256, 16, 64, "float32"), None),
    "int8_main": ((4096, 128, 1, 32, "int8"), ("fused", 128)),
    "fp16_two_kernel": ((2 ** 22, 256, 16, 64, "float16"),
                        ("two_kernel", 128)),
    # the grouped kernel fits a 49152-block list beside its ring only with
    # the narrow stage halved (from 16 int8 tokens to 8)
    "narrow_halved": ((49152 * 128, 128, 4, 32, "int8"),
                      ("two_kernel", 128)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_plan_decode_routes_as_before(case):
    (smax, dim, g, d, storage), want = ROUTES[case]
    plan = tuning.plan_decode(smax, dim, g, d, 128, storage=storage)
    assert (plan and (plan.variant, plan.block_size)) == want
    nb = smax // 128
    sel = tuning.select_smem_bytes(nb=nb, g=g, kdim=dim, d=d, bs=128,
                                   storage=storage)
    tok, row = tuning.score_tokens(d=d, bs=128,
                                   itemsize=tuning.ITEMSIZE[storage])
    fixed = 4 * g * dim + 4 * nb + 64
    if case == "halved_chunk":
        assert fixed + 4 * 2 * tok * row > tuning.SMEM_LIMIT
        assert sel == fixed + 4 * 2 * (tok // 2) * row <= tuning.SMEM_LIMIT
    elif want is not None:
        assert sel == fixed + 4 * 2 * tok * row <= tuning.SMEM_LIMIT
    if case == "narrow_halved":
        att = dict(n_sel=nb, g=g, kdim=dim, dim=dim, storage=storage)
        full = tuning.split_stage_bytes(kdim=dim, dim=dim, storage=storage)
        half = tuning.split_stage_bytes(kdim=dim, dim=dim, storage=storage,
                                        tok=8)
        assert 4 * g * dim + 4 * nb + 4 * 2 * full > tuning.SMEM_LIMIT
        assert tuning.attend_smem_bytes(**att) == \
            4 * g * dim + 4 * nb + 4 * 2 * half <= tuning.SMEM_LIMIT


def test_paged_and_quantized_arguments_raise():
    """A page size the block does not divide is refused (a block must not
    straddle two pages), and so are per-page scales the reference kernels
    assert against: scales on a contiguous cache, k_scale without v_scale,
    and a scale whose length is not the pool's page count."""
    q, k, v, cur = _t(*_inputs(1, 1, 1, 32, 16, 16, seed=0, cur=[3]))
    table = torch.zeros((1, 2), dtype=torch.int32)
    pool = k[0]                                  # (R, Hkv, W) = (32, 1, 16)
    with pytest.raises(ValueError, match="tile pages"):
        fused_decode.fused_loki_decode(q, pool, v[0], cur, d=8, k_blocks=1,
                                       block_size=16, page_table=table,
                                       page_size=8)
    with pytest.raises(ValueError, match="require paged caches"):
        fused_decode.select_blocks(q, k, cur, d=8, k_blocks=1,
                                   block_size=16, k_scale=torch.ones(2))
    with pytest.raises(ValueError, match="require paged caches"):
        gather_attention.block_sparse_attention_grouped(
            q, k, v, torch.zeros((1, 1, 1), dtype=torch.int32), cur,
            block_size=16, v_scale=torch.ones(2))
    with pytest.raises(ValueError, match="come together"):
        gather_attention.paged_full_decode(q, pool, v[0], cur, block_size=16,
                                           page_table=table, page_size=16,
                                           k_scale=torch.ones(2))
    with pytest.raises(ValueError, match="one entry per pool page"):
        fused_decode.fused_exact_topk_decode(
            q, pool, v[0], cur, k_blocks=1, block_size=16, page_table=table,
            page_size=16, k_scale=torch.ones(3), v_scale=torch.ones(3))


def test_cpu_tensors_never_launch():
    """CPU tensors take the plain versions; the launch counters, bumped
    only where a CUDA kernel launches, stay put."""
    from repro_torch import kernels as K
    K.reset_launch_counts()
    q, k, v, cur = _t(*_inputs(1, 2, 2, 64, 16, 16, seed=1, cur=[40]))
    ops.loki_decode_fused(q, k, v, cur, d=8, k_blocks=2, block_size=16)
    ops.loki_decode_two_kernel(q, k, v, cur, d=8, k_blocks=2, block_size=16)
    ops.full_decode(q, k, v, cur, block_size=16)
    ops.exact_topk_decode_fused(q, k, v, cur, k_blocks=2, block_size=16)
    # per-head rows: (Hkv, W), (Hkv, S, W), (Hkv, S, D)
    qh = q[0, :, 0].contiguous()
    kh, vh = (x[0].transpose(0, 1).contiguous() for x in (k, v))
    ops.loki_decode_attention(qh, kh, vh, cur.repeat(2), d=8, k_blocks=2,
                              block_size=16)
    ops.loki_decode_attention_fm(qh, kh.transpose(1, 2).contiguous(), vh,
                                 cur.repeat(2), d=8, k_blocks=2,
                                 block_size=16)
    ops.flash(kh, kh, vh, causal=True, block_q=16, block_k=16)
    assert K.launch_counts() == {
        "fused_loki_decode": 0, "select_blocks": 0,
        "block_sparse_attention_grouped": 0, "paged_full_decode": 0,
        "fused_exact_topk_decode": 0, "flash_attention": 0,
        "block_max_scores": 0, "block_sparse_attention": 0,
        "block_max_scores_fm": 0}


# ------------------------------------------------------ paged pools, #4, #5

def _paged(k, v, ps, seed, trash_rows=0):
    """Scatter contiguous (B,S,Hkv,·) caches into a pool through a shuffled
    (non-monotone) page table; page 0 stays the trash page. The last
    ``trash_rows`` batch rows get all-zero table rows, as idle slots do in
    the paged engine. Returns (pool_k, pool_v, table, logical k, v): the
    logical caches are what the table reads, trash rows included."""
    b, s, hkv, _ = k.shape
    mp = s // ps
    live = b - trash_rows
    rng = np.random.RandomState(seed)
    table = np.zeros((b, mp), np.int32)
    table[:live] = (rng.permutation(live * mp) + 1).reshape(live, mp)
    n_pages = live * mp + 1
    pool_k = rng.randn(n_pages * ps, hkv, k.shape[-1]).astype(np.float32)
    pool_v = rng.randn(n_pages * ps, hkv, v.shape[-1]).astype(np.float32)
    for i in range(live):
        for p in range(mp):
            rows = slice(table[i, p] * ps, (table[i, p] + 1) * ps)
            pool_k[rows] = k[i, p * ps:(p + 1) * ps]
            pool_v[rows] = v[i, p * ps:(p + 1) * ps]
    rows = (table[:, :, None] * ps + np.arange(ps)).reshape(b, s)
    return pool_k, pool_v, table, pool_k[rows], pool_v[rows]


PAGED = [(16, 16), (16, 32)]                         # (block, page) sizes


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("bs,ps", PAGED)
def test_paged_loki_kernels_match_jax(g, bs, ps):
    """#1-#3 in paged mode over a shuffled pool with a trash-page row: the
    plain versions against the JAX kernels in interpret mode (exact block
    indices), and against their own contiguous runs on the logical view."""
    dim, w, s = 32, 32, 128
    q, k, v, cur = _inputs(3, 2, g, s, w, dim, seed=g + bs + ps,
                           cur=[113, 40, 1])
    pk, pv, table, lk, lv = _paged(k, v, ps, seed=g, trash_rows=1)
    kw = dict(d=8, k_blocks=3, block_size=bs, local_window=8,
              scale=dim ** -0.5)
    pkw = dict(kw, page_size=ps)
    want_idx = np.asarray(jfused.select_blocks(
        *_j(q, pk, cur), page_table=jnp.asarray(table), **pkw,
        interpret=True))
    tq, tpk, tpv, tcur, ttab = _t(q, pk, pv, cur, table)
    got_idx = fused_decode.select_blocks(tq, tpk, tcur, page_table=ttab,
                                         **pkw)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(
        got_idx.numpy(),
        fused_decode.select_blocks(*_t(q, lk, cur), **kw).numpy())
    want = np.asarray(jfused.fused_loki_decode(
        *_j(q, pk, pv, cur), page_table=jnp.asarray(table), **pkw,
        interpret=True))
    got = fused_decode.fused_loki_decode(tq, tpk, tpv, tcur,
                                         page_table=ttab, **pkw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, fused_decode.fused_loki_decode(
        *_t(q, lk, lv, cur), **kw).numpy())
    att_kw = dict(block_size=bs, scale=dim ** -0.5, page_size=ps)
    want_att = np.asarray(jgather.block_sparse_attention_grouped(
        *_j(q, pk, pv, want_idx, cur), page_table=jnp.asarray(table),
        **att_kw, interpret=True))
    got_att = gather_attention.block_sparse_attention_grouped(
        tq, tpk, tpv, got_idx, tcur, page_table=ttab, **att_kw).numpy()
    np.testing.assert_allclose(got_att, want_att, **TOL)


FULL = [(1, 0, False), (4, 0, False), (1, 40, True), (4, 40, True),
        (4, 0, True)]                                # (G, window, paged)


@pytest.mark.parametrize("g,sw,paged", FULL)
def test_full_decode_matches_jax(g, sw, paged):
    """#4: the streaming full decode, contiguous and paged, ragged
    cur_len, a sliding window, G in {1, 4}, W < D in one case."""
    dim, bs, s = 32, 16, 128
    w = 16 if g == 4 and sw else dim
    q, k, v, cur = _inputs(3, 2, g, s, w, dim, seed=g + sw,
                           cur=[128, 57, 1])
    kw = dict(block_size=bs, sliding_window=sw,
              scale=None if w == dim else dim ** -0.5)
    if paged:
        pk, pv, table, _, _ = _paged(k, v, 32, seed=g, trash_rows=1)
        kw.update(page_size=32)
        jargs = (*_j(q, pk, pv, cur),)
        targs = (*_t(q, pk, pv, cur),)
        jkw = dict(kw, page_table=jnp.asarray(table))
        tkw = dict(kw, page_table=torch.from_numpy(table))
    else:
        jargs, targs, jkw, tkw = _j(q, k, v, cur), _t(q, k, v, cur), kw, kw
    want = np.asarray(jgather.paged_full_decode(*jargs, **jkw,
                                                interpret=True))
    got = gather_attention.paged_full_decode(*targs, **tkw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jops_want = np.asarray(jops.full_decode(*jargs, **jkw, interpret=True))
    np.testing.assert_allclose(ops.full_decode(*targs, **tkw).numpy(),
                               jops_want, **TOL)


_SPLIT_JAX: dict = {}


def _split_case(g, sw, paged):
    """Inputs of the split-KV tests, the JAX kernel's output on them
    (interpret mode, computed once per (G, window, paged)) and the logical
    (contiguous) caches that a paged case's table reads."""
    dim, bs, s = 32, 16, 128
    w = 16 if g == 4 else dim
    q, k, v, cur = _inputs(3, 2, g, s, w, dim, seed=7 * g + sw,
                           cur=[128, 57, 1])
    kw = dict(block_size=bs, sliding_window=sw, scale=dim ** -0.5)
    if paged:
        pk, pv, table, k, v = _paged(k, v, 32, seed=g, trash_rows=1)
        args = (q, pk, pv, cur)
        jkw = dict(kw, page_table=jnp.asarray(table), page_size=32)
        tkw = dict(kw, page_table=torch.from_numpy(table), page_size=32)
    else:
        args, jkw, tkw = (q, k, v, cur), kw, kw
    key = (g, sw, paged)
    if key not in _SPLIT_JAX:
        _SPLIT_JAX[key] = np.asarray(jgather.paged_full_decode(
            *_j(*args), **jkw, interpret=True))
    return args, tkw, _SPLIT_JAX[key], (q, k, v, cur)


@pytest.mark.parametrize("n_split", [1, 2, 3, 12])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sw", [0, 40])
@pytest.mark.parametrize("paged", [False, True])
def test_full_decode_split_matches_jax(n_split, g, sw, paged):
    """#4's split-KV arithmetic (each split's partial over its share of the
    live blocks, then the log-sum-exp merge) against the JAX kernel, with
    n_split 1, 2, 3 and more than the 8 blocks of a row: the row with
    cur_len 1 has one live block, so its other splits are empty (alpha = 0
    in the merge), as are the trailing ones at n_split 12. Paged equals
    contiguous on the logical data exactly."""
    args, tkw, want, (q, k, v, cur) = _split_case(g, sw, paged)
    got = gather_attention.full_decode_split_plain(*_t(*args), **tkw,
                                                   n_split=n_split)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if paged:
        contig = gather_attention.full_decode_split_plain(
            *_t(q, k, v, cur), block_size=tkw["block_size"],
            sliding_window=sw, scale=tkw["scale"], n_split=n_split)
        np.testing.assert_array_equal(got.numpy(), contig.numpy())


@pytest.mark.parametrize("sw", [0, 40])
def test_split_blocks_cover_every_live_block_once(sw):
    """For every cur_len of a 128-token, 16-token-block cache and every
    n_split from 1 to past the block count, the splits' [first, end)
    ranges are disjoint and their union is exactly the live block range
    [window's first block, ceil(cur_len / bs))."""
    bs, nb = 16, 8
    cur = torch.arange(1, nb * bs + 1)
    for n_split in range(1, nb + 3):
        span = gather_attention.split_blocks(cur, nb, bs, n_split, sw)
        for i, ln in enumerate(cur.tolist()):
            lo = max(ln - sw, 0) // bs if sw else 0
            hi = min(nb, -(-ln // bs))
            covered = [blk for first, end in span[i].tolist()
                       for blk in range(first, end)]
            assert covered == list(range(lo, hi)), (ln, n_split, covered)


def test_full_decode_n_split_rule_reads_shapes_only():
    """The host's split count is a function of three ints (blocks per row,
    B * Hkv, SMs), never of a tensor, so it costs the paged tick no sync:
    about 4 CTAs per SM, at least 1, at most one split per block."""
    import inspect
    rule = gather_attention.full_decode_n_split
    params = inspect.signature(rule).parameters
    assert [p.annotation for p in params.values()] == ["int"] * 3
    assert rule(32, 128, 132) == 4                 # llama2-7b, 4 slots
    assert rule(32, 4 * 8, 132) == 16              # qwen2.5-3b: 2 kv heads
    assert rule(2, 8, 132) == 2                    # capped by the blocks
    assert rule(32, 1024, 132) == 1                # never below one
    for rows in range(1, 600):
        n = rule(32, rows, 132)
        assert 1 <= n <= 32 and (n == 1 or n == 32 or
                                 rows * n <= 4 * 132 < rows * (n + 1))


_CLUSTER_JAX: dict = {}


@pytest.mark.parametrize("n_cta", [1, 2, 3, 8])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sw", [0, 40])
@pytest.mark.parametrize("paged", [False, True])
def test_fused_cluster_matches_jax(n_cta, g, sw, paged):
    """#1 and #5's cluster form (per-CTA score shares, the shared top-k,
    per-CTA attention partials, the rank-ordered log-sum-exp merge)
    against the JAX kernel in interpret mode, computed once per (G,
    window) on the logical cache: fused_loki_decode (recency window 8) at
    (G 1, no window) and (G 4, window 40), fused_exact_topk_decode at the
    other two, so each kernel meets both G and both windows. C = 1, 2, 3
    and 8 = S / bs, which is more CTAs than live blocks in every row (the
    window leaves 3; cur_len 30 and 1 leave 2 and 1, fewer than k_blocks,
    so -1 sentinels and empty shares). A paged pool through a shuffled
    table with a trash-page row equals the contiguous cache bit for
    bit."""
    dim, bs, s = 32, 16, 128
    w = 16 if g == 4 else dim
    q, k, v, cur = _inputs(3, 2, g, s, w, dim, seed=3 * g + sw,
                           cur=[128, 30, 1])
    # the caches are the logical view of a pool (the last row reads the
    # trash page), so the contiguous and paged cases share one JAX output
    pk, pv, table, k, v = _paged(k, v, 32, seed=g, trash_rows=1)
    kw = dict(k_blocks=4, block_size=bs, sliding_window=sw,
              scale=dim ** -0.5)
    loki_case = (g == 1) == (sw == 0)
    extra = dict(d=8, local_window=8) if loki_case else \
        dict(d=w, local_window=0)
    if (g, sw) not in _CLUSTER_JAX:
        if loki_case:
            out = jfused.fused_loki_decode(*_j(q, k, v, cur), **extra, **kw,
                                           interpret=True)
        else:
            out = jfused.fused_exact_topk_decode(*_j(q, k, v, cur), **kw,
                                                 interpret=True)
        _CLUSTER_JAX[(g, sw)] = np.asarray(out)
    got = fused_decode.fused_cluster_plain(*_t(q, k, v, cur), **extra, **kw,
                                           n_cta=n_cta).numpy()
    np.testing.assert_allclose(got, _CLUSTER_JAX[(g, sw)], **TOL)
    if paged:
        got_p = fused_decode.fused_cluster_plain(
            *_t(q, pk, pv, cur), **extra, **kw, n_cta=n_cta,
            page_table=torch.from_numpy(table), page_size=32).numpy()
        np.testing.assert_array_equal(got_p, got)


def test_fused_cluster_size_rule_reads_shapes_only():
    """The host's cluster size is a function of three ints (blocks per
    row, B * Hkv, SMs), never of a tensor, so it costs the paged tick no
    sync: about 4 CTAs per SM, at least 1, at most 8 (the portable cluster
    limit) and at most one CTA per block."""
    import inspect
    rule = fused_decode.fused_cluster_size
    params = inspect.signature(rule).parameters
    assert [p.annotation for p in params.values()] == ["int"] * 3
    assert rule(32, 128, 132) == 4                 # llama2-7b, 4 slots
    assert rule(32, 4 * 2, 132) == 8               # qwen2.5-3b: the limit
    assert rule(2, 8, 132) == 2                    # capped by the blocks
    assert rule(32, 1024, 132) == 1                # never below one
    for nb in (1, 3, 32):
        for rows in range(1, 600):
            n = rule(nb, rows, 132)
            assert 1 <= n <= min(8, nb) and (
                n in (1, 8, nb) or rows * n <= 4 * 132 < rows * (n + 1))


@pytest.mark.parametrize("sw", [0, 40])
def test_fused_cluster_shares_cover_each_block_and_winner_once(sw):
    """For every cur_len of a 128-token, 16-token-block cache and every
    cluster size the rule can give (1 to 8), the CTAs' score shares are
    disjoint and cover exactly the live block range, and for every count
    of valid winners (0 to k_blocks) their attention shares are disjoint
    and cover exactly the winners, in rank order."""
    bs, nb, kb = 16, 8, 4
    cur = torch.arange(1, nb * bs + 1)
    for n_cta in range(1, 9):
        span = gather_attention.split_blocks(cur, nb, bs, n_cta, sw)
        for i, ln in enumerate(cur.tolist()):
            lo = max(ln - sw, 0) // bs if sw else 0
            covered = [blk for first, end in span[i].tolist()
                       for blk in range(first, end)]
            assert covered == list(range(lo, min(nb, -(-ln // bs))))
        shares = fused_decode.winner_shares(torch.arange(kb + 1), n_cta)
        for nv in range(kb + 1):
            taken = [t for first, end in shares[nv].tolist()
                     for t in range(first, end)]
            assert taken == list(range(nv)), (n_cta, nv, taken)


_GROUPED_JAX: dict = {}


@pytest.mark.parametrize("n_cta", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
def test_grouped_cluster_matches_jax(n_cta, g):
    """#3's cluster form (entries in [0, nb) kept in list order, per-CTA
    shares, partials and the rank-ordered log-sum-exp merge) against the
    JAX kernel in interpret mode, contiguous and through a shuffled pool
    with a trash-page row (bit for bit equal to contiguous). G 1 without
    a window, G 4 with window 40; the selection holds -1 entries, a block
    past cur_len and an empty row; C = 3 leaves empty shares."""
    dim, bs, s = 32, 16, 128
    sw = 40 if g == 4 else 0
    w = 16 if g == 4 else dim
    q, k, v, cur = _inputs(3, 2, g, s, w, dim, seed=13 * g, cur=[128, 30, 1])
    pk, pv, table, k, v = _paged(k, v, 32, seed=g, trash_rows=1)
    blk = np.array([[[7, -1, 2, 5], [0, 6, -1, -1]],
                    [[1, 0, 6, -1], [-1, -1, -1, -1]],
                    [[0, -1, 3, -1], [2, 0, -1, 1]]], np.int32)
    kw = dict(block_size=bs, sliding_window=sw, scale=dim ** -0.5)
    if g not in _GROUPED_JAX:
        _GROUPED_JAX[g] = np.asarray(jgather.block_sparse_attention_grouped(
            *_j(q, k, v, blk, cur), **kw, interpret=True))
    got = gather_attention.grouped_cluster_plain(*_t(q, k, v, blk, cur),
                                                 **kw, n_cta=n_cta)
    np.testing.assert_allclose(got.numpy(), _GROUPED_JAX[g], **TOL)
    assert (got[1, 1] == 0).all()                  # an all -1 row: zeros
    got_p = gather_attention.grouped_cluster_plain(
        *_t(q, pk, pv, blk, cur), **kw, n_cta=n_cta,
        page_table=torch.from_numpy(table), page_size=32)
    assert torch.equal(got_p, got)


def test_grouped_cluster_equals_fused_cluster_on_its_selection():
    """The pair's arithmetic is the fused kernel's: select_blocks' output
    (winners, then -1) through #3's cluster form equals #1's cluster form
    at every C, which is what lets the card hold the pair to the fused
    kernel bit for bit."""
    dim, bs, s = 32, 16, 128
    q, k, v, cur = _inputs(3, 2, 4, s, dim, dim, seed=17, cur=[128, 30, 1])
    kw = dict(block_size=bs, scale=dim ** -0.5, sliding_window=0)
    sel = fused_decode.select_blocks(*_t(q, k, cur), d=8, k_blocks=4,
                                     local_window=8, **kw)
    assert (sel == -1).any()
    for n_cta in (1, 2, 3, 4):
        fused = fused_decode.fused_cluster_plain(
            *_t(q, k, v, cur), d=8, k_blocks=4, local_window=8, **kw,
            n_cta=n_cta)
        pair = gather_attention.grouped_cluster_plain(
            *_t(q, k, v), sel, torch.from_numpy(cur), **kw, n_cta=n_cta)
        assert torch.equal(pair, fused), n_cta


def test_attend_smem_bytes_layout():
    """The block-list kernels' shared memory (csrc/decode_common.cuh,
    attend_layout) at the main path's shapes: query 512 B, kept list 8
    ints (32 B), and the 4 warps' rings of 2 stages of 4 fp32 (or, per
    head, 8 bf16) tokens x (128 + 128), which the merges reuse."""
    main = dict(n_sel=8, g=1, kdim=128, dim=128)
    assert tuning.attend_smem_bytes(**main, storage="float32") == \
        512 + 32 + 4 * 2 * 4 * 256 * 4
    assert tuning.attend_smem_bytes(**main, storage="bfloat16", tok=8) == \
        tuning.attend_smem_bytes(**main, storage="float32")
    # G 16 at D 256: the merge buffers (5 x 16 x 258 floats) outgrow the
    # rings; a list of every block of a 2**22-token cache still fits
    assert tuning.attend_smem_bytes(n_sel=8, g=16, kdim=256, dim=256,
                                    storage="float32") == \
        16384 + 32 + 5 * 16 * 258 * 4
    assert tuning.attend_smem_bytes(n_sel=2 ** 15, g=16, kdim=256, dim=256,
                                    storage="float32") <= tuning.SMEM_LIMIT
    # the narrow body's rings: fp16 in 8-token stages (K rows padded to 17
    # 16-byte pieces), fp8 in 16-token ones (9-piece K rows, then the
    # page's two scales in 16 B), int8:pca:r=32 in 32-token ones (3-piece
    # K rows)
    assert tuning.attend_smem_bytes(**main, storage="float16") == \
        512 + 32 + 4 * 2 * 8 * (272 + 256)
    assert tuning.attend_smem_bytes(**main, storage="float8_e4m3fn") == \
        512 + 32 + 4 * 2 * (16 * (144 + 128) + 16)
    assert tuning.attend_smem_bytes(n_sel=8, g=1, kdim=32, dim=128,
                                    storage="int8") == \
        128 + 32 + 4 * 2 * (32 * (48 + 128) + 16)


EXACT = [(1, 0, False), (4, 0, False), (4, 40, False), (1, 0, True),
         (4, 40, True)]                              # (G, window, paged)


@pytest.mark.parametrize("g,sw,paged", EXACT)
def test_exact_topk_kernel_matches_jax(g, sw, paged):
    """#5: the fused exact-top-k decode, contiguous and paged, ragged
    cur_len (a short row leaves -1 sentinels), a sliding window."""
    dim, bs, s = 32, 16, 128
    q, k, v, cur = _inputs(3, 2, g, s, dim, dim, seed=5 * g + sw,
                           cur=[128, 30, 1])
    kw = dict(k_blocks=4, block_size=bs, sliding_window=sw)
    if paged:
        pk, pv, table, lk, lv = _paged(k, v, 32, seed=g, trash_rows=1)
        jkw = dict(kw, page_table=jnp.asarray(table), page_size=32)
        tkw = dict(kw, page_table=torch.from_numpy(table), page_size=32)
        jargs, targs = _j(q, pk, pv, cur), _t(q, pk, pv, cur)
    else:
        lk, lv = k, v
        jargs, targs, jkw, tkw = _j(q, k, v, cur), _t(q, k, v, cur), kw, kw
    want = np.asarray(jfused.fused_exact_topk_decode(*jargs, **jkw,
                                                     interpret=True))
    got = fused_decode.fused_exact_topk_decode(*targs, **tkw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        ops.exact_topk_decode_fused(*targs, **tkw).numpy(),
        np.asarray(jops.exact_topk_decode_fused(*jargs, **jkw,
                                                interpret=True)), **TOL)
    # the selection it attends: select_blocks at d = W on the logical view
    sel = fused_decode.select_blocks(*_t(q, lk, cur), d=dim,
                                     scale=dim ** -0.5, local_window=0,
                                     **kw).numpy()
    np.testing.assert_array_equal(sel, np.asarray(jfused.select_blocks(
        *_j(q, lk, cur), d=dim, scale=dim ** -0.5, local_window=0, **kw,
        interpret=True)))
    assert (sel[2] == -1).any()                     # the cur_len-1 row


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_exact_topk_oracles_match_jax(g, paged):
    """The block oracle (group-shared and per-head) and the token
    reference, and the fused kernel against the group-shared oracle."""
    b, hkv, s, dim, bs = 2, 2, 128, 32, 16
    rng = np.random.RandomState(g)
    q = rng.randn(b, hkv * g, dim).astype(np.float32)
    k = rng.randn(b, s, hkv, dim).astype(np.float32)
    v = rng.randn(b, s, hkv, dim).astype(np.float32)
    cur = np.array([s, 45], np.int32)
    jcfg = JLokiConfig(enabled=True, k_f=0.25, block_size=bs)
    cfg = LokiConfig(**dataclasses.asdict(jcfg))
    pargs, jpargs, kc, vc = {}, {}, k, v
    if paged:
        kc, vc, table, _, _ = _paged(k, v, 32, seed=g)
        pargs = dict(page_table=torch.from_numpy(table), page_size=32)
        jpargs = dict(page_table=jnp.asarray(table), page_size=32)
    for group_select in (True, False):
        want = np.asarray(jbaselines.exact_topk_decode_block(
            *_j(q, kc, vc, cur), jcfg, group_select=group_select,
            **jpargs))
        got = baselines.exact_topk_decode_block(
            *_t(q, kc, vc, cur), cfg, group_select=group_select,
            **pargs).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        if group_select:
            fused = fused_decode.fused_exact_topk_decode(
                *_t(q.reshape(b, hkv, g, dim), kc, vc, cur), k_blocks=2,
                block_size=bs, **pargs).numpy()
            np.testing.assert_allclose(fused.reshape(b, hkv * g, dim),
                                       want, **TOL)
    want = np.asarray(jbaselines.exact_topk_decode(*_j(q, k, v, cur), jcfg))
    got = baselines.exact_topk_decode(*_t(q, k, v, cur), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("policy", ["loki_block", "full", "exact_topk"])
def test_paged_dispatch_matches_jax(backend, policy):
    """Each policy's dispatch over a paged pool, both backends, against
    JAX's dispatch on the same pool and table."""
    b, hkv, g, s, dim, bs = 2, 2, 2, 128, 32, 16
    rng = np.random.RandomState(len(policy))
    q = rng.randn(b, hkv * g, dim).astype(np.float32)
    k = rng.randn(b, s, hkv, dim).astype(np.float32)
    v = rng.randn(b, s, hkv, dim).astype(np.float32)
    proj = _orthogonal(hkv, dim, seed=2)
    cur = np.array([100, 17], np.int32)
    pk, pv, table, _, _ = _paged(k, v, 32, seed=5)
    jcfg = JLokiConfig(enabled=True, block_size=bs, backend=backend)
    cfg = LokiConfig(**dataclasses.asdict(jcfg))
    jp = dict(page_table=jnp.asarray(table), page_size=32)
    tp = dict(page_table=torch.from_numpy(table), page_size=32)
    if policy == "loki_block":
        want = jdispatch.loki_block_decode(*_j(q, pk, pv, cur, proj), jcfg,
                                           interpret=True, **jp)
        got = dispatch.loki_block_decode(*_t(q, pk, pv, cur, proj), cfg,
                                         **tp)
    elif policy == "full":
        kw = dict(backend=backend, block_size=bs, logit_scale=dim ** -0.5)
        want = jdispatch.full_paged_decode(*_j(q, pk, pv, cur), **kw,
                                           interpret=True, **jp)
        got = dispatch.full_paged_decode(*_t(q, pk, pv, cur), **kw, **tp)
    else:
        want = jdispatch.exact_topk_paged_decode(
            *_j(q, pk, pv, cur), jcfg, logit_scale=dim ** -0.5,
            interpret=True, **jp)
        got = dispatch.exact_topk_paged_decode(
            *_t(q, pk, pv, cur), cfg, logit_scale=dim ** -0.5, **tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plan_full_decode():
    assert tuning.plan_full_decode(4096, 128, 1, 128, 128) == \
        tuning.KernelPlan("stream", 128)
    assert tuning.plan_full_decode(96, 64, 2, 64, 128).block_size == 32
    assert tuning.plan_full_decode(4096, 128, 32, 128, 128) is None
    assert tuning.plan_full_decode(100, 128, 1, 128, 128) is None
    # the split-KV kernel's shared memory (csrc/gather_attention.cu,
    # split_smem_bytes): the query + 4 warps x 2 stages x 4 rows of K̂ and
    # V in the cache dtype; llama2-7b's fp32 cache 32.5 KB
    assert tuning.full_smem_bytes(g=1, kdim=128, dim=128,
                                  storage="float32") == \
        512 + 4 * 2 * 4 * 256 * 4
    assert tuning.full_smem_bytes(g=1, kdim=128, dim=128,
                                  storage="bfloat16") == \
        512 + 4 * 2 * 4 * 256 * 2
    # the widest case the kernel takes fits the 227 KB limit, in any dtype;
    # there the warps' merge (16 x 258 floats each) outgrows the ring
    widest = tuning.full_smem_bytes(g=16, kdim=256, dim=256,
                                    storage="float32")
    assert widest == 16 * 256 * 4 + 4 * 4 * 16 * 258 <= tuning.SMEM_LIMIT
    assert tuning.plan_full_decode(4096, 256, 16, 256, 128,
                                   storage="float32") == \
        tuning.KernelPlan("stream", 128)
    # odd widths pad rows to 4 elements and the ring stage to 16 bytes
    assert tuning.full_smem_bytes(g=2, kdim=30, dim=62,
                                  storage="bfloat16") == \
        2 * 32 * 4 + 4 * 2 * (4 * (32 + 64) * 2)
    # exact_topk plans the fused kernel at d = kd, as JAX does
    assert tuning.plan_decode(4096, 128, 1, 128, 128) == \
        tuning.KernelPlan("fused", 128)


CUDA_RAISES = ["full_no_plan", "exact_topk_no_plan", "loki_block_page",
               "full_page", "exact_topk_page", "full_disabled"]


@pytest.mark.parametrize("case", CUDA_RAISES)
def test_cuda_paged_dispatch_raises(case, monkeypatch):
    """On a CUDA tensor the kernel backend never falls back: no plan for
    the shape (G = 32 > 16), a paged block that does not divide the page
    (page 8, block 16), or a disabled backend raises. The tensors pose as
    CUDA ones; the raise comes before any device op (chip_smoke.py checks
    the same on the card). On the CPU the same calls run the plain path."""
    g = 32 if case.endswith("no_plan") else 1
    ps = 8 if case.endswith("page") else 16
    rng = np.random.RandomState(1)
    q = rng.randn(1, g, 16).astype(np.float32)
    pool = rng.randn(128 + ps, 1, 16).astype(np.float32)
    table = np.arange(1, 128 // ps + 1, dtype=np.int32)[None]
    args = _t(q, pool, pool, np.array([50], np.int32))
    tp = dict(page_table=torch.from_numpy(table), page_size=ps)
    cfg = LokiConfig(enabled=True, block_size=16, backend="pallas")
    policy = case.split("_no_plan")[0].split("_page")[0].split(
        "_disabled")[0]

    def call():
        if policy == "full":
            return dispatch.full_paged_decode(*args, backend="pallas",
                                              block_size=16, **tp)
        if policy == "exact_topk":
            return dispatch.exact_topk_paged_decode(*args, cfg, **tp)
        proj = torch.eye(16)[None]
        return dispatch.loki_block_decode(*args, proj, cfg, **tp)

    assert call().shape == (1, g, 16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    if case == "full_disabled":
        dispatch.disable_backend("pallas", "test")
        try:
            with pytest.raises(RuntimeError, match="disabled"):
                dispatch.full_paged_decode(*args, backend="auto",
                                           block_size=16, **tp)
        finally:
            dispatch.enable_backend("pallas")
        return
    with pytest.raises(NotImplementedError, match="no CUDA kernel plan"):
        call()
