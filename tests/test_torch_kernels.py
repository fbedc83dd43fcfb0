"""The port's decode kernels against the JAX package's Pallas kernels.

On CPU tensors the port's wrappers run the kernels' plain torch versions
(the CUDA kernels are held against those same plain versions on the card by
chip_smoke.py). Here the plain versions meet the JAX kernels in interpret
mode on the same numpy inputs: block indices must be equal, outputs within
rtol = atol = 2e-5 — the tolerance tests/test_fused_decode.py uses for two
float32 implementations that sum in different orders.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LokiConfig as JLokiConfig
from repro.core import dispatch as jdispatch
from repro.core import loki as jloki
from repro.kernels import fused_decode as jfused
from repro.kernels import gather_attention as jgather
from repro.kernels import ops as jops
from repro_torch.configs.base import LokiConfig
from repro_torch.core import dispatch, loki
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
    # a score row too long for the fused kernel's shared memory
    big = tuning.plan_decode(2 ** 22, 256, 16, 64, 128)
    assert big == tuning.KernelPlan("two_kernel", 128)
    assert tuning.plan_decode(4096, 128, 32, 32, 128) is None      # G > 16
    assert tuning.plan_decode(4096, 512, 1, 32, 128) is None       # D > 256
    assert tuning.plan_decode(100, 128, 1, 32, 128) is None        # no bs
    assert tuning.plan_decode(96, 64, 2, 16, 128).block_size == 32


def test_paged_and_quantized_arguments_raise():
    q, k, v, cur = _t(*_inputs(1, 1, 1, 32, 16, 16, seed=0, cur=[3]))
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged kernels"):
        fused_decode.fused_loki_decode(q, k, v, cur, d=8, k_blocks=1,
                                       block_size=16, page_table=table,
                                       page_size=16)
    with pytest.raises(NotImplementedError, match="paged kernels"):
        fused_decode.select_blocks(q, k, cur, d=8, k_blocks=1,
                                   block_size=16, k_scale=torch.ones(2))
    with pytest.raises(NotImplementedError, match="paged kernels"):
        gather_attention.block_sparse_attention_grouped(
            q, k, v, torch.zeros((1, 1, 1), dtype=torch.int32), cur,
            block_size=16, v_scale=torch.ones(2))


def test_cpu_tensors_never_launch():
    """CPU tensors take the plain versions; the launch counters, bumped
    only where a CUDA kernel launches, stay put."""
    from repro_torch import kernels as K
    K.reset_launch_counts()
    q, k, v, cur = _t(*_inputs(1, 2, 2, 64, 16, 16, seed=1, cur=[40]))
    ops.loki_decode_fused(q, k, v, cur, d=8, k_blocks=2, block_size=16)
    ops.loki_decode_two_kernel(q, k, v, cur, d=8, k_blocks=2, block_size=16)
    assert K.launch_counts() == {"fused_loki_decode": 0, "select_blocks": 0,
                                 "block_sparse_attention_grouped": 0}
